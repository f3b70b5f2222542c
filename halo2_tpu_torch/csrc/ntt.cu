// K1's transform entry: the size-m DIF Stockham transform along axis 1 of a
// (16, m, B) limb array, every stage in one launch.
//
// Replaces, on the card, the JAX package's jitted ntt_sixstep
// (halo2_tpu/ops/ntt.py:184-209), whose Stockham stages (:159-181) XLA fuses
// around one call a stage of the Pallas product mont_mul_rows
// (halo2_tpu/fields/pallas_kernels.py:129).  The port ran each stage as an
// eager add, sub, K1 product and concat: about 300 launches a stage, ~4,800
// for a 2^16 six-step.
//
// Stage t (s = 2^t, h = m / 2s) reads a column as (2h, s) and writes, for
// j < h and r < s, into the (h, 2s) layout
//     out[j, r]     = x[j, r] + x[j + h, r]
//     out[j, r + s] = (x[j, r] - x[j + h, r]) * w^(s j),
// so butterfly p = j s + r always reads positions p and p + m/2.  After the
// last stage the column is in natural order.
//
// Design.  A block takes the 2^L elements of a tile of consecutive batch
// columns, so every limb row is read and written along B.  It packs them to
// 8 words at the load, in structure-of-arrays order (word j of element e at
// j * E + e) so that neighbouring threads hit neighbouring banks, runs the L
// stages between two shared-memory buffers with K1's own h2::add, h2::sub
// and h2::mont_mul, and writes once.  Twiddles are read from the (16, m/2)
// table in device memory (at most 64 KB, served by the caches).  Two buffers
// of 2^11 elements of 32 bytes are 128 KB, above the 48 KB a block gets
// without cudaFuncSetAttribute, so one launch runs at most kMaxStages = 11
// stages.  A longer axis (an extended domain above 2^22, which no
// configuration of the repo reaches) runs as several launches of this
// kernel: stages [t0, t0 + L) see the column as (J, s0), J = m / s0, and mix
// only the rows j0 + q G (q < 2^L, G = J / 2^L) at one r < s0; that group
// ends at rows j0 2^L s0 + r + q s0.  A short axis takes several columns a
// block, up to kTileElems elements.
//
// What bounds it: each element is read and written once (128 bytes of
// device memory) and takes L/2 products of 136 multiply-adds; on an H100 the
// two bounds meet near L = 9.  At the main path's sizes (2^15 to 2^21
// elements, L = 7 to 11) a block's threads do one or a few butterflies a
// stage, each stage a dependent product behind a barrier, so it is latency-
// bound; nothing is done about that here (no wgmma, TMA or tuning).
//
// Every step returns the unique value in [0, p) for inputs in [0, p), so the
// output equals the eager stage loop limb for limb.
#include <cuda_runtime.h>

#include <algorithm>

#include "field.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 11;
constexpr int kTileElems = 512;

struct Pass {
  int64_t m;     // axis length, a power of two
  int64_t cols;  // B, the batch columns
  int t0;        // first stage of this launch
  int L;         // stages of this launch
  int log_tile;  // log2 of the columns a block takes
};

__global__ void __launch_bounds__(kMaxThreads)
    stockham_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                    const int32_t* __restrict__ tw, Pass ps, h2::Modulus md) {
  extern __shared__ uint32_t smem[];
  const int tile = 1 << ps.log_tile;
  const int half = (1 << ps.L) >> 1;       // butterflies of one column a stage
  const int E = (1 << ps.L) << ps.log_tile;  // elements of the block
  uint32_t* src = smem;
  uint32_t* dst = smem + h2::NW * E;
  const int64_t ntiles = (ps.cols + tile - 1) >> ps.log_tile;
  const int64_t group = blockIdx.x / ntiles;
  const int64_t b0 = (blockIdx.x % ntiles) << ps.log_tile;
  const int64_t s0 = int64_t{1} << ps.t0;
  const int64_t G = ps.m >> (ps.t0 + ps.L);
  const int64_t j0 = group / s0, r0 = group % s0;
  const int64_t limb_stride = ps.m * ps.cols;

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int q = e >> ps.log_tile, c = e & (tile - 1);
    if (b0 + c < ps.cols) {
      uint32_t w[h2::NW];
      h2::load_strided(w, x, limb_stride, ((j0 + q * G) * s0 + r0) * ps.cols + b0 + c);
#pragma unroll
      for (int j = 0; j < h2::NW; ++j) src[j * E + e] = w[j];
    }
  }
  __syncthreads();

  for (int l = 0; l < ps.L; ++l) {
    // local layout (2^(L-l), 2^l): butterfly p = q 2^l + r reads p and p + half
    for (int e = threadIdx.x; e < (E >> 1); e += blockDim.x) {
      const int p = e >> ps.log_tile, c = e & (tile - 1);
      const int q = p >> l, r = p & ((1 << l) - 1);
      const int i1 = e + (half << ps.log_tile);
      uint32_t a[h2::NW], b[h2::NW], u[h2::NW], w[h2::NW];
#pragma unroll
      for (int j = 0; j < h2::NW; ++j) {
        a[j] = src[j * E + e];
        b[j] = src[j * E + i1];
      }
      h2::add(u, a, b, md);
      h2::sub(a, a, b, md);
      h2::load_strided(w, tw, ps.m >> 1, (j0 + q * G) << (ps.t0 + l));
      h2::mont_mul(a, a, w, md);
      const int o0 = ((((q << 1) << l) + r) << ps.log_tile) + c;
      const int o1 = o0 + ((1 << l) << ps.log_tile);
#pragma unroll
      for (int j = 0; j < h2::NW; ++j) {
        dst[j * E + o0] = u[j];
        dst[j * E + o1] = a[j];
      }
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }

  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int q = e >> ps.log_tile, c = e & (tile - 1);
    if (b0 + c < ps.cols) {
      uint32_t w[h2::NW];
#pragma unroll
      for (int j = 0; j < h2::NW; ++j) w[j] = src[j * E + e];
      h2::store_strided(out, limb_stride, (j0 * (s0 << ps.L) + r0 + q * s0) * ps.cols + b0 + c,
                        w);
    }
  }
}

}  // namespace

// Stages [t0, t0 + L) of the transform of x (16, m, cols) into out (same
// shape, not aliasing x); tw is the (16, m/2) table of the m-th root's
// powers.  m a power of two, 0 <= L <= 11, t0 + L <= log2 m.
// p_words: 8 little-endian 32-bit words of p (host memory); n0 = -p^-1 mod 2^32.
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int h2_stockham(const int32_t* x, int32_t* out, const int32_t* tw, int64_t m,
                           int64_t cols, int64_t t0, int64_t L, const uint32_t* p_words,
                           uint32_t n0, void* stream) {
  if (L < 0 || L > kMaxStages || t0 < 0 || m < 1 || (m & (m - 1)) != 0 ||
      (m >> (t0 + L)) < 1 || cols < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  h2::Modulus md;
  for (int j = 0; j < h2::NW; ++j) md.p[j] = p_words[j];
  md.n0 = n0;
  Pass ps{m, cols, static_cast<int>(t0), static_cast<int>(L), 0};
  while ((int64_t{2} << ps.log_tile) <= cols && (2 << (ps.log_tile + ps.L)) <= kTileElems) {
    ++ps.log_tile;
  }
  const int E = (1 << ps.L) << ps.log_tile;
  const int threads = std::min(kMaxThreads, std::max(32, E / 2));
  const size_t smem = size_t{2} * h2::NW * sizeof(uint32_t) * E;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stockham_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t ntiles = (cols + (int64_t{1} << ps.log_tile) - 1) >> ps.log_tile;
  const int64_t blocks = (m >> L) * ntiles;
  stockham_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(x, out, tw, ps, md);
  return static_cast<int>(cudaGetLastError());
}
