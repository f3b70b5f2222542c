// K4: elementwise Montgomery product out = a * b * 2^-256 mod p, computed with
// the TPU kernel's own algorithm.
//
// Replaces the Pallas kernel halo2_tpu/fields/pallas_kernels.py
// mont_mul_pallas (_mont_mul_kernel, body _mont_mul_block): the lane-tiled
// (16, n) product that the JAX package keeps beside K1 (mont_mul_rows) and
// compares with it.  K1 (mont_mul.cu) packs limbs into 8 x 32-bit words and
// runs CIOS with 64-bit products; this kernel keeps the TPU's 16-bit limbs:
// 256 16x16-bit products, each split into lo/hi halves and summed into 32
// column accumulators, word-by-word REDC over 16-bit digits, a carry pass
// over the high half and a conditional subtract of p.  The result in [0, p)
// is unique, so it equals K1's limb for limb; what differs is the work.
//
// Bound: integer issue, on the ALU.  Each element moves the same 192 bytes
// as K1 but issues 2253 instructions (1000 on the multiply pipe: the 528
// products and 469 adds that ptxas moves there as IMAD.IADD; 1253 on the
// ALU: the masks, and LEA.HI, which adds a shifted high half in one
// instruction), where K1 issues 603, so the ALU, not device memory, sets
// its time at large widths.
// The design keeps all 64 limbs and accumulators of an element in one
// thread's registers, and every column sum in 32 bits without a carry until
// the end (a column stays below 2^23).  The columns are tiled as the JAX
// grid tiles them: one block of TILE = 512 threads per (16, 512) tile, the
// ragged last tile masked instead of padded.  Nothing goes through shared
// memory: each element is read once, limb l of neighbouring columns lies in
// neighbouring words so the loads coalesce, and a staging copy would add
// traffic without any reuse to pay for it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NL = 16;          // 16-bit limbs per element
constexpr int kTile = 512;      // columns per block: the JAX kernel's TILE
constexpr uint32_t kMask = 0xFFFFu;

struct Modulus16 {
  uint32_t p[NL];  // 16-bit little-endian limbs of p
  uint32_t n0;     // -p^-1 mod 2^16
};

__global__ void __launch_bounds__(kTile)
    mont_mul_tiled_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                          int32_t* __restrict__ out, int64_t n, Modulus16 m) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  if (col >= n) return;  // the ragged edge of the last tile
  uint32_t x[NL], y[NL], t[2 * NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    x[l] = static_cast<uint32_t>(a[l * n + col]);
    y[l] = static_cast<uint32_t>(b[l * n + col]);
  }
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t[k] = 0;
  // schoolbook: column i + j takes the low half of x_i * y_j, column
  // i + j + 1 the high half
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint32_t prod = x[i] * y[j];
      t[i + j] += prod & kMask;
      t[i + j + 1] += prod >> 16;
    }
  }
  // word-by-word REDC: q makes digit i vanish; its carry moves to digit i + 1
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t q = (t[i] * m.n0) & kMask;
    const uint32_t prod0 = q * m.p[0];
    const uint32_t low = t[i] + (prod0 & kMask);
    t[i + 1] += (low >> 16) + (prod0 >> 16);
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      const uint32_t prod = q * m.p[j];
      t[i + j] += prod & kMask;
      t[i + j + 1] += prod >> 16;
    }
  }
  // carry-normalise the high half; the value is below 2p < 2^256, so the
  // final carry is zero
  uint32_t r[NL];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint32_t v = t[NL + k] + carry;
    r[k] = v & kMask;
    carry = v >> 16;
  }
  // conditional subtract: keep r when r - p borrows
  uint32_t d[NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint32_t v = r[k] + (1u << 16) - m.p[k] - borrow;
    d[k] = v & kMask;
    borrow = 1u - (v >> 16);
  }
#pragma unroll
  for (int l = 0; l < NL; ++l) out[l * n + col] = static_cast<int32_t>(borrow ? r[l] : d[l]);
}

}  // namespace

// p_limbs: 16 little-endian 16-bit limbs of p (host memory); n0 = -p^-1 mod
// 2^16.  Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int h2_mont_mul_tiled(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                                 const uint32_t* p_limbs, uint32_t n0, void* stream) {
  Modulus16 m;
  for (int l = 0; l < NL; ++l) m.p[l] = p_limbs[l];
  m.n0 = n0;
  const int64_t blocks = (n + kTile - 1) / kTile;
  mont_mul_tiled_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
