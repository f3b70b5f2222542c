// K2 / K3: complete projective addition and doubling on y^2 = x^3 + b (a = 0),
// and the two chains of K3 that the main path runs.
//
// Replace the Pallas kernels halo2_tpu/curves/pallas_ec.py _ec_add_pallas
// (_ec_add_kernel, body ec_add_body: Renes-Costello-Batina 2016 Algorithm 7)
// and _ec_double_pallas (_ec_double_kernel, body ec_double_body: Algorithm 9),
// which carry every add and double of the JAX package's MSM.  The bodies are
// the device functions of ec.cuh.
//
// K2 / K3: one thread per point over (16, n) int32 limb arrays, one array per
// coordinate.  Every intermediate stays in registers, as the TPU kernel keeps
// them in VMEM: an add reads 6 coordinates and writes 3 (576 bytes) for 12
// full Montgomery products, a double reads 3 and writes 3 (384 bytes) for 8,
// so unlike K1 the work per byte is high enough for integer multiply, not
// memory, to bound them at large n.
//
// The chains.  On the main path K3 runs almost only in two long chains of
// dependent launches over few points, which the JAX package runs as one
// fori_loop inside one jitted program each (ops/scalar_mul.py
// batch_scalar_mul, ops/msm.py _combine_windows_horner).  Here each chain is
// one launch, one thread per point, the whole chain in registers:
//
//  - ec_scalar_mul_kernel: out = k * P per lane, double-and-add over the 256
//    bits of k, low bit first, in batch_scalar_mul's order (acc = bit ?
//    acc + base : acc; base = 2 base).  Acc, base and the scalar stay in
//    registers (138 a thread, no spills).  At the widths the main path gives
//    it (2^13 for a group-NTT stage or the first IPA fold round, down to a
//    single point in the last rounds) each SM holds one or two warps, so
//    each thread's dependent chain of ~256 doublings and adds bounds it:
//    latency, not issue rate or bytes.  Where the lanes' bits differ, the
//    warp runs the add on every step.  Blocks of 64 threads spread 2^13
//    points over 128 SMs.
//  - ec_horner_kernel: the window fold of msm_many: acc = S[W-1], then for
//    each earlier window c doublings and acc + S[w].  One thread per MSM
//    column, m = 1 to ~20 columns in one warp: purely the latency of
//    (W-1)(c+1) dependent point operations (140 registers, no spills).
//
// On an H100 (700 W; chip_smoke.py phase 12) a step of either chain costs
// about 1 us of dependent latency per Montgomery product's worth of work,
// so ec_scalar_mul takes 4-9 ms and ec_horner 3-4 ms, against integer-issue
// bounds of 0.17 ms (2^13 points) and microseconds.  Shared memory, TMA and
// the tensor cores have nothing to do here: no operand is reused across
// threads, and the arithmetic is 32-bit integer multiply-adds with carries,
// which the tensor cores do not offer.  What the design does about the
// latency bound is to take the host out of the chain: one launch in place of
// (W-1)(c+1) launches or 256 steps of three, each of which cost tens of us
// of host time for a few us of device time.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

using h2::Modulus;
using h2::NW;

__global__ void ec_add_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                              const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                              const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                              int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                              int32_t* __restrict__ oz, int64_t n, Modulus m, uint32_t b3) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X1[NW], Y1[NW], Z1[NW], X2[NW], Y2[NW], Z2[NW];
  h2::load(X1, x1, n, i);
  h2::load(Y1, y1, n, i);
  h2::load(Z1, z1, n, i);
  h2::load(X2, x2, n, i);
  h2::load(Y2, y2, n, i);
  h2::load(Z2, z2, n, i);
  h2::ec_add(X1, Y1, Z1, X1, Y1, Z1, X2, Y2, Z2, m, b3);
  h2::store(ox, n, i, X1);
  h2::store(oy, n, i, Y1);
  h2::store(oz, n, i, Z1);
}

__global__ void ec_double_kernel(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                                 const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
                                 int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n,
                                 Modulus m, uint32_t b3) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t X[NW], Y[NW], Z[NW];
  h2::load(X, x1, n, i);
  h2::load(Y, y1, n, i);
  h2::load(Z, z1, n, i);
  h2::ec_double(X, Y, Z, X, Y, Z, m, b3);
  h2::store(ox, n, i, X);
  h2::store(oy, n, i, Y);
  h2::store(oz, n, i, Z);
}

struct Words {
  uint32_t w[NW];
};

constexpr int kChainThreads = 64;

// k: canonical scalar limbs (16, n); one: R mod p, the identity's y.
__global__ void __launch_bounds__(kChainThreads)
    ec_scalar_mul_kernel(const int32_t* __restrict__ k, const int32_t* __restrict__ px,
                         const int32_t* __restrict__ py, const int32_t* __restrict__ pz,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int64_t n, Modulus m, uint32_t b3, Words one) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t s[NW], BX[NW], BY[NW], BZ[NW], AX[NW], AY[NW], AZ[NW];
  h2::load(s, k, n, i);
  h2::load(BX, px, n, i);
  h2::load(BY, py, n, i);
  h2::load(BZ, pz, n, i);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    AX[j] = 0;
    AY[j] = one.w[j];
    AZ[j] = 0;
  }
#pragma unroll 1
  for (int bit = 0; bit < 256; ++bit) {
    if (s[0] & 1u) h2::ec_add(AX, AY, AZ, AX, AY, AZ, BX, BY, BZ, m, b3);
    // shift the scalar right by one: bit b+1 comes to the bottom without
    // indexing a register array by a loop variable (which would spill it)
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) s[j] = __funnelshift_r(s[j], s[j + 1], 1);
    s[NW - 1] >>= 1;
    // the last double's result is never read
    if (bit < 255) h2::ec_double(BX, BY, BZ, BX, BY, BZ, m, b3);
  }
  h2::store(ox, n, i, AX);
  h2::store(oy, n, i, AY);
  h2::store(oz, n, i, AZ);
}

// sums: (16, m, w) window sums, column j's window v at element j * w + v of
// the (16, m * w) arrays; out: (16, m).
__global__ void __launch_bounds__(kChainThreads)
    ec_horner_kernel(const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
                     const int32_t* __restrict__ sz, int32_t* __restrict__ ox,
                     int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t m, int w, int c,
                     Modulus mod, uint32_t b3) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int64_t total = m * w;
  uint32_t AX[NW], AY[NW], AZ[NW], QX[NW], QY[NW], QZ[NW];
  h2::load(AX, sx, total, j * w + w - 1);
  h2::load(AY, sy, total, j * w + w - 1);
  h2::load(AZ, sz, total, j * w + w - 1);
#pragma unroll 1
  for (int v = w - 2; v >= 0; --v) {
#pragma unroll 1
    for (int d = 0; d < c; ++d) h2::ec_double(AX, AY, AZ, AX, AY, AZ, mod, b3);
    h2::load(QX, sx, total, j * w + v);
    h2::load(QY, sy, total, j * w + v);
    h2::load(QZ, sz, total, j * w + v);
    h2::ec_add(AX, AY, AZ, AX, AY, AZ, QX, QY, QZ, mod, b3);
  }
  h2::store(ox, m, j, AX);
  h2::store(oy, m, j, AY);
  h2::store(oz, m, j, AZ);
}

Modulus make_modulus(const uint32_t* p_words, uint32_t n0) {
  Modulus m;
  for (int j = 0; j < NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  return m;
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// Coordinates in the base field given by (p_words, n0); b3 = 3 * b as a small
// integer.  Launch on `stream`, allocate nothing, do not synchronise.
extern "C" int h2_ec_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, const int32_t* z2, int32_t* ox,
                         int32_t* oy, int32_t* oz, int64_t n, const uint32_t* p_words,
                         uint32_t n0, uint32_t b3, void* stream) {
  ec_add_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n, make_modulus(p_words, n0), b3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2_ec_double(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                            int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                            const uint32_t* p_words, uint32_t n0, uint32_t b3, void* stream) {
  ec_double_kernel<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, ox, oy, oz, n, make_modulus(p_words, n0), b3);
  return static_cast<int>(cudaGetLastError());
}

// k: canonical scalar limbs (16, n); one_words: R mod p in the base field
// (8 little-endian words, host memory).
extern "C" int h2_ec_scalar_mul(const int32_t* k, const int32_t* px, const int32_t* py,
                                const int32_t* pz, int32_t* ox, int32_t* oy, int32_t* oz,
                                int64_t n, const uint32_t* p_words, uint32_t n0, uint32_t b3,
                                const uint32_t* one_words, void* stream) {
  Words one;
  for (int j = 0; j < NW; ++j) one.w[j] = one_words[j];
  ec_scalar_mul_kernel<<<blocks_for(n, kChainThreads), kChainThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      k, px, py, pz, ox, oy, oz, n, make_modulus(p_words, n0), b3, one);
  return static_cast<int>(cudaGetLastError());
}

// sums: three (16, m * w) arrays; out: three (16, m) arrays; c doublings
// between windows.
extern "C" int h2_ec_horner(const int32_t* sx, const int32_t* sy, const int32_t* sz,
                            int32_t* ox, int32_t* oy, int32_t* oz, int64_t m, int64_t w,
                            int64_t c, const uint32_t* p_words, uint32_t n0, uint32_t b3,
                            void* stream) {
  ec_horner_kernel<<<blocks_for(m, kChainThreads), kChainThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      sx, sy, sz, ox, oy, oz, m, static_cast<int>(w), static_cast<int>(c),
      make_modulus(p_words, n0), b3);
  return static_cast<int>(cudaGetLastError());
}
