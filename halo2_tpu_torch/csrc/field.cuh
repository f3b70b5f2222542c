// Shared device arithmetic for 256-bit prime fields (BN254 Fr/Fq, Pasta Fp/Fq).
//
// In device memory a batch of n field elements is the JAX package's layout:
// a (16, n) int32 array of 16-bit little-endian limbs in Montgomery form
// (R = 2^256), limb-major, so limb l of element i sits at l * n + i and a warp
// reading one limb of 32 neighbouring elements reads 128 contiguous bytes.
// In registers an element is 8 little-endian 32-bit words; the two forms are
// packed and unpacked at the load and the store.
//
// With R = 2^256 fixed and every input in [0, p), the Montgomery product
// a*b*R^-1 mod p in [0, p) is unique, so the 32-bit CIOS product below gives
// the same limbs as the 16-bit word-by-word REDC of the JAX package
// (halo2_tpu/fields/vreg.py vmul) without mirroring its schedule.
//
// The modulus travels as a kernel argument (struct Modulus, placed in the
// constant bank by the launch), so one kernel serves every field.
#pragma once

#include <cstdint>

namespace h2 {

constexpr int NW = 8;  // 32-bit words per element

struct Modulus {
  uint32_t p[NW];  // little-endian words of p
  uint32_t n0;     // -p^-1 mod 2^32
};

// Pack limbs 2j, 2j+1 of element i into word j.
__device__ __forceinline__ void load(uint32_t w[NW], const int32_t* __restrict__ src,
                                     int64_t n, int64_t i) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint32_t lo = static_cast<uint32_t>(src[(2 * j) * n + i]);
    uint32_t hi = static_cast<uint32_t>(src[(2 * j + 1) * n + i]);
    w[j] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void store(int32_t* __restrict__ dst, int64_t n, int64_t i,
                                      const uint32_t w[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    dst[(2 * j) * n + i] = static_cast<int32_t>(w[j] & 0xFFFFu);
    dst[(2 * j + 1) * n + i] = static_cast<int32_t>(w[j] >> 16);
  }
}

// r = s - p if s >= p (or the sum carried out of 2^256), else s.
__device__ __forceinline__ void reduce_once(uint32_t r[NW], const uint32_t s[NW],
                                            uint32_t carry, const Modulus& m) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = static_cast<uint64_t>(s[j]) - m.p[j] - borrow;
    d[j] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);  // 1 when the difference wrapped
  }
  const bool take = carry != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = take ? d[j] : s[j];
}

// r = a + b mod p; a, b in [0, p).  r may alias a or b.
__device__ __forceinline__ void add(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW],
                                    const Modulus& m) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = static_cast<uint64_t>(a[j]) + b[j] + c;
    s[j] = static_cast<uint32_t>(t);
    c = t >> 32;
  }
  reduce_once(r, s, static_cast<uint32_t>(c), m);
}

// r = a - b mod p; a, b in [0, p).  r may alias a or b.
__device__ __forceinline__ void sub(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW],
                                    const Modulus& m) {
  uint32_t d[NW];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = static_cast<uint64_t>(a[j]) - b[j] - borrow;
    d[j] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  // a < b: add p back (the carry out of that addition cancels the borrow)
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t t = static_cast<uint64_t>(d[j]) + (m.p[j] & mask) + c;
    r[j] = static_cast<uint32_t>(t);
    c = t >> 32;
  }
}

// r = a * b * 2^-256 mod p (CIOS, 32-bit words, 64-bit products); a, b in
// [0, p) and p < 2^255, so the pre-subtraction value is below 2p < 2^256.
// r may alias a or b.
__device__ __forceinline__ void mont_mul(uint32_t r[NW], const uint32_t a[NW],
                                         const uint32_t b[NW], const Modulus& m) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = static_cast<uint64_t>(a[j]) * b[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[NW]) + c;
    t[NW] = static_cast<uint32_t>(s);
    t[NW + 1] = static_cast<uint32_t>(s >> 32);
    // t = (t + q * p) / 2^32 with q chosen so the low word vanishes
    const uint32_t q = t[0] * m.n0;
    s = static_cast<uint64_t>(q) * m.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = static_cast<uint64_t>(q) * m.p[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[NW]) + c;
    t[NW - 1] = static_cast<uint32_t>(s);
    t[NW] = t[NW + 1] + static_cast<uint32_t>(s >> 32);
  }
  reduce_once(r, t, t[NW], m);
}

// r = k * a mod p for a small positive k, by double-and-add (the JAX
// package's vreg.vmul_small).  r may alias a.
__device__ __forceinline__ void mul_small(uint32_t r[NW], const uint32_t a[NW], uint32_t k,
                                          const Modulus& m) {
  uint32_t base[NW], acc[NW];
  bool have = false;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    base[j] = a[j];
    acc[j] = 0;
  }
  while (k) {
    if (k & 1u) {
      if (have) {
        add(acc, acc, base, m);
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j) acc[j] = base[j];
        have = true;
      }
    }
    k >>= 1;
    if (k) add(base, base, base, m);
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = acc[j];
}

}  // namespace h2
