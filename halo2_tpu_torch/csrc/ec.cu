// K2 / K3: complete projective addition and doubling on y^2 = x^3 + b (a = 0).
//
// Replace the Pallas kernels halo2_tpu/curves/pallas_ec.py _ec_add_pallas
// (_ec_add_kernel, body ec_add_body: Renes-Costello-Batina 2016 Algorithm 7)
// and _ec_double_pallas (_ec_double_kernel, body ec_double_body: Algorithm 9),
// which carry every add and double of the JAX package's MSM.
//
// One thread per point over (16, n) int32 limb arrays, one array per
// coordinate.  Every intermediate stays in registers, as the TPU kernel keeps
// them in VMEM: an add reads 6 coordinates and writes 3 (576 bytes) for 12
// full Montgomery products, a double reads 3 and writes 3 (384 bytes) for 7,
// so unlike K1 the work per byte is high enough for integer multiply, not
// memory, to bound them.  The formulas and their order follow the JAX bodies
// exactly, so the projective outputs are bit-identical to theirs.
#include <cuda_runtime.h>

#include "field.cuh"

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

  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW], v[NW];
  h2::mont_mul(t0, X1, X2, m);
  h2::mont_mul(t1, Y1, Y2, m);
  h2::mont_mul(t2, Z1, Z2, m);
  h2::add(u, X1, Y1, m);
  h2::add(v, X2, Y2, m);
  h2::mont_mul(t3, u, v, m);
  h2::sub(t3, t3, t0, m);
  h2::sub(t3, t3, t1, m);  // x1y2 + x2y1
  h2::add(u, Y1, Z1, m);
  h2::add(v, Y2, Z2, m);
  h2::mont_mul(t4, u, v, m);
  h2::sub(t4, t4, t1, m);
  h2::sub(t4, t4, t2, m);  // y1z2 + y2z1
  // the inputs are dead from here on: reuse their registers
  uint32_t* y3 = X1;
  h2::add(u, X1, Z1, m);
  h2::add(v, X2, Z2, m);
  h2::mont_mul(y3, u, v, m);
  h2::sub(y3, y3, t0, m);
  h2::sub(y3, y3, t2, m);  // x1z2 + x2z1
  uint32_t* t0x3 = Y1;
  h2::add(t0x3, t0, t0, m);
  h2::add(t0x3, t0x3, t0, m);
  uint32_t* t2b = Z1;
  h2::mul_small(t2b, t2, b3, m);
  uint32_t* z3 = X2;
  h2::add(z3, t1, t2b, m);
  uint32_t* t1m = Y2;
  h2::sub(t1m, t1, t2b, m);
  uint32_t* y3b = Z2;
  h2::mul_small(y3b, y3, b3, m);

  h2::mont_mul(u, t3, t1m, m);
  h2::mont_mul(v, t4, y3b, m);
  h2::sub(u, u, v, m);
  h2::store(ox, n, i, u);
  h2::mont_mul(u, y3b, t0x3, m);
  h2::mont_mul(v, t1m, z3, m);
  h2::add(u, u, v, m);
  h2::store(oy, n, i, u);
  h2::mont_mul(u, z3, t4, m);
  h2::mont_mul(v, t0x3, t3, m);
  h2::add(u, u, v, m);
  h2::store(oz, n, i, u);
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

  uint32_t t0[NW], t1[NW], t2[NW], z3[NW], u[NW], v[NW];
  h2::mont_mul(t0, Y, Y, m);
  h2::add(z3, t0, t0, m);
  h2::add(z3, z3, z3, m);
  h2::add(z3, z3, z3, m);  // 8y^2
  h2::mont_mul(t1, Y, Z, m);
  h2::mont_mul(u, Z, Z, m);
  h2::mul_small(t2, u, b3, m);
  uint32_t* x3 = Z;  // z is dead after yz and z^2
  h2::mont_mul(x3, t2, z3, m);
  h2::add(u, t0, t2, m);  // y3
  h2::mont_mul(v, t1, z3, m);
  h2::store(oz, n, i, v);
  h2::add(v, t2, t2, m);
  h2::add(v, v, t2, m);   // 3 t2
  h2::sub(t0, t0, v, m);  // t0m
  h2::mont_mul(u, t0, u, m);
  h2::add(u, x3, u, m);
  h2::store(oy, n, i, u);
  h2::mont_mul(v, X, Y, m);
  h2::mont_mul(v, t0, v, m);
  h2::add(v, v, v, m);
  h2::store(ox, n, i, v);
}

Modulus make_modulus(const uint32_t* p_words, uint32_t n0) {
  Modulus m;
  for (int j = 0; j < NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  return m;
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// Coordinates in the base field given by (p_words, n0); b3 = 3 * b as a small
// integer.  Launch on `stream`, allocate nothing, do not synchronise.
extern "C" int h2_ec_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, const int32_t* z2, int32_t* ox,
                         int32_t* oy, int32_t* oz, int64_t n, const uint32_t* p_words,
                         uint32_t n0, uint32_t b3, void* stream) {
  ec_add_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, x2, y2, z2, ox, oy, oz, n, make_modulus(p_words, n0), b3);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2_ec_double(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                            int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                            const uint32_t* p_words, uint32_t n0, uint32_t b3, void* stream) {
  ec_double_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, y1, z1, ox, oy, oz, n, make_modulus(p_words, n0), b3);
  return static_cast<int>(cudaGetLastError());
}
