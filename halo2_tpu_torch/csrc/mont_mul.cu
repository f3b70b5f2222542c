// K1: elementwise Montgomery product out = a * b * 2^-256 mod p, and its
// chain entry, the power out = a^e.
//
// Replaces the Pallas kernel halo2_tpu/fields/pallas_kernels.py
// mont_mul_rows (_mont_mul_rows_kernel, body fields/vreg.py vmul), which the
// JAX package runs under every field multiply on the TPU.
//
// One thread per element over (16, n) int32 limb arrays.  Each thread reads
// 16 limbs of a and of b and writes 16 limbs: 192 bytes moved for about 150
// 32-bit multiply-adds.  Standalone it is therefore bound by device-memory
// bandwidth, not by integer multiply; the loads are coalesced (limb l of
// neighbouring elements are neighbouring words) and nothing else is done
// about it here.  That bound is why the EC kernels (ec.cu) fuse their dozen
// products instead of calling this one twelve times.
//
// mont_pow_kernel: out = a^e for one exponent e shared by every element,
// square-and-multiply over the bits of e, low bit first, in registers.  On
// the main path K1 ran almost only inside the Fermat inversion a^(p-2): a
// Python loop of 327 to 379 dependent launches (bit length - 1 squarings
// plus popcount - 1 products), which the JAX package runs as one fori_loop
// inside one jitted program (halo2_tpu/fields/limb.py fpow_const).  Here the
// whole chain is one launch.  What bounds it is the dependent latency of the
// ~360 products in each thread: on an H100 (700 W) a launch takes the same
// 0.21-0.25 ms at n = 1, 7 and 2^14 (chip_smoke.py phase 12), about 0.65 us
// per product, while the integer-issue bound at 2^14 is 0.05 ms.  Issue
// would bind only from about n = 2^16 up, where the main path never calls
// it (affine conversions at n = 1 to ~20; column inversions and
// batch_normalize at 2^14 to 2^15).  So the design spends nothing on
// throughput: blocks of 64 threads spread 2^14 elements over all 132 SMs
// (256 blocks), and at 40 registers a thread every block is resident at
// once.  The exponent travels in the constant bank like the modulus and is
// shifted in registers, so the bit loop never indexes an array by a loop
// variable.  The products are K1's own h2::mont_mul, whose result in [0, p)
// is unique, so the output equals the loop of K1 launches limb for limb.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int64_t n, h2::Modulus m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[h2::NW], y[h2::NW];
  h2::load(x, a, n, i);
  h2::load(y, b, n, i);
  h2::mont_mul(x, x, y, m);
  h2::store(out, n, i, x);
}

struct Exponent {
  uint32_t w[h2::NW];  // little-endian words of e
  int nbits;           // bit length of e, >= 1
};

constexpr int kPowThreads = 64;

__global__ void __launch_bounds__(kPowThreads)
    mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n,
                    h2::Modulus m, Exponent e) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t base[h2::NW], acc[h2::NW], bits[h2::NW];
  h2::load(base, a, n, i);
#pragma unroll
  for (int j = 0; j < h2::NW; ++j) bits[j] = e.w[j];
  bool have = false;  // acc holds a power yet (the same for every thread)
#pragma unroll 1
  for (int b = 0; b < e.nbits; ++b) {
    if (bits[0] & 1u) {
      if (have) {
        h2::mont_mul(acc, acc, base, m);
      } else {
#pragma unroll
        for (int j = 0; j < h2::NW; ++j) acc[j] = base[j];
        have = true;
      }
    }
#pragma unroll
    for (int j = 0; j < h2::NW - 1; ++j) bits[j] = __funnelshift_r(bits[j], bits[j + 1], 1);
    bits[h2::NW - 1] >>= 1;
    if (b + 1 < e.nbits) h2::mont_mul(base, base, base, m);
  }
  h2::store(out, n, i, acc);
}

}  // namespace

// p_words: 8 little-endian 32-bit words of p (host memory); n0 = -p^-1 mod 2^32.
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int h2_mont_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                           const uint32_t* p_words, uint32_t n0, void* stream) {
  h2::Modulus m;
  for (int j = 0; j < h2::NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  mont_mul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

// e_words: 8 little-endian 32-bit words of the exponent (host memory), nbits
// its bit length (1 to 256).
extern "C" int h2_mont_pow(const int32_t* a, int32_t* out, int64_t n, const uint32_t* p_words,
                           uint32_t n0, const uint32_t* e_words, int64_t nbits, void* stream) {
  h2::Modulus m;
  for (int j = 0; j < h2::NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  Exponent e;
  for (int j = 0; j < h2::NW; ++j) e.w[j] = e_words[j];
  e.nbits = static_cast<int>(nbits);
  const int64_t blocks = (n + kPowThreads - 1) / kPowThreads;
  mont_pow_kernel<<<static_cast<unsigned>(blocks), kPowThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, out, n, m, e);
  return static_cast<int>(cudaGetLastError());
}
