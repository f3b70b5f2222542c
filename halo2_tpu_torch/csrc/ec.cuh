// Complete projective addition and doubling on y^2 = x^3 + b (a = 0), on
// register arrays.
//
// The bodies of the JAX package's Pallas kernels halo2_tpu/curves/pallas_ec.py
// ec_add_body (Renes-Costello-Batina 2016 Algorithm 7) and ec_double_body
// (Algorithm 9), as device functions: K2 and K3 (ec.cu) call them once per
// thread, and the chain kernels of ec.cu call them in loops that keep every
// point in registers.  The formulas and their order follow the JAX bodies, so
// the projective outputs are bit-identical to theirs and to the plain torch
// versions (curves/ec_kernels.py).  A point is three coordinate arrays of
// h2::NW words in the base field's Montgomery form; the identity is (0, R, 0).
#pragma once

#include "field.cuh"

namespace h2 {

__device__ __forceinline__ void copy(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = a[j];
}

// (X3, Y3, Z3) = (X1, Y1, Z1) + (X2, Y2, Z2); b3 = 3 * b as a small integer.
// Every input is read before the first output is written, so the outputs may
// alias either input.
__device__ __forceinline__ void ec_add(uint32_t X3[NW], uint32_t Y3[NW], uint32_t Z3[NW],
                                       const uint32_t X1[NW], const uint32_t Y1[NW],
                                       const uint32_t Z1[NW], const uint32_t X2[NW],
                                       const uint32_t Y2[NW], const uint32_t Z2[NW],
                                       const Modulus& m, uint32_t b3) {
  uint32_t t0[NW], t1[NW], t2[NW], t3[NW], t4[NW], u[NW], v[NW];
  mont_mul(t0, X1, X2, m);
  mont_mul(t1, Y1, Y2, m);
  mont_mul(t2, Z1, Z2, m);
  add(u, X1, Y1, m);
  add(v, X2, Y2, m);
  mont_mul(t3, u, v, m);
  sub(t3, t3, t0, m);
  sub(t3, t3, t1, m);  // x1y2 + x2y1
  add(u, Y1, Z1, m);
  add(v, Y2, Z2, m);
  mont_mul(t4, u, v, m);
  sub(t4, t4, t1, m);
  sub(t4, t4, t2, m);  // y1z2 + y2z1
  uint32_t y3[NW];
  add(u, X1, Z1, m);
  add(v, X2, Z2, m);  // the last read of the inputs
  mont_mul(y3, u, v, m);
  sub(y3, y3, t0, m);
  sub(y3, y3, t2, m);  // x1z2 + x2z1
  uint32_t t0x3[NW], t2b[NW], z3[NW], t1m[NW], y3b[NW];
  add(t0x3, t0, t0, m);
  add(t0x3, t0x3, t0, m);
  mul_small(t2b, t2, b3, m);
  add(z3, t1, t2b, m);
  sub(t1m, t1, t2b, m);
  mul_small(y3b, y3, b3, m);

  mont_mul(u, t3, t1m, m);
  mont_mul(v, t4, y3b, m);
  sub(X3, u, v, m);
  mont_mul(u, y3b, t0x3, m);
  mont_mul(v, t1m, z3, m);
  add(Y3, u, v, m);
  mont_mul(u, z3, t4, m);
  mont_mul(v, t0x3, t3, m);
  add(Z3, u, v, m);
}

// (X3, Y3, Z3) = 2 (X, Y, Z).  The outputs are written last and may alias the
// input.
__device__ __forceinline__ void ec_double(uint32_t X3[NW], uint32_t Y3[NW], uint32_t Z3[NW],
                                          const uint32_t X[NW], const uint32_t Y[NW],
                                          const uint32_t Z[NW], const Modulus& m, uint32_t b3) {
  uint32_t t0[NW], t1[NW], t2[NW], z3[NW], u[NW], v[NW], x3[NW], zo[NW], yo[NW];
  mont_mul(t0, Y, Y, m);
  add(z3, t0, t0, m);
  add(z3, z3, z3, m);
  add(z3, z3, z3, m);  // 8y^2
  mont_mul(t1, Y, Z, m);
  mont_mul(u, Z, Z, m);
  mul_small(t2, u, b3, m);
  mont_mul(x3, t2, z3, m);
  add(u, t0, t2, m);  // y3
  mont_mul(zo, t1, z3, m);
  add(v, t2, t2, m);
  add(v, v, t2, m);   // 3 t2
  sub(t0, t0, v, m);  // t0m
  mont_mul(u, t0, u, m);
  add(yo, x3, u, m);
  mont_mul(v, X, Y, m);  // the last read of the input
  mont_mul(v, t0, v, m);
  add(X3, v, v, m);
  copy(Y3, yo);
  copy(Z3, zo);
}

}  // namespace h2
