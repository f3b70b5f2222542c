// The lookup argument's multiset matching (lookup/prover.rs:391-475) on the
// compressed columns as limbs, after ops/lookup.py has sorted both columns'
// first u values by their 256-bit canonical keys: three launches.
//
// Replaces no TPU kernel: the JAX package runs the matching on the host over
// Python ints (halo2_tpu/plonk/prover.py _permute_expression_pair), as the
// reference does, and the port did too, with a pull of both columns before
// and a conversion of both results back to limbs after (PERF.md).
//
//  - lookup_first_kernel: one thread per sorted input row i.  Copies the
//    input value comp_input[:, idx_in[i]] into perm_input[:, i]; on the first
//    row of each distinct value also into perm_table[:, i], then finds the
//    value's first entry in the sorted table by a lower bound on the key
//    (17 probes of four 64-bit words at u = 2^17) and marks it used, or sets
//    the missing flag.  Distinct values have distinct first entries, so no
//    two threads write one flag.
//  - lookup_rank_kernel: one block of 1024 threads walks the rows in tiles
//    of 1024 and scans two flags at once (warp shuffles, then the 32 warp
//    sums): the repeated input rows and the unused table entries, each list
//    ascending, and their lengths.  A single block keeps the scan in one
//    pass with no second launch for the block sums; at u = 2^17 it is 128
//    tiles.
//  - lookup_fill_kernel: one thread per leftover t: the t-th unused table
//    value (ascending) goes to the t-th repeated row from the last, which is
//    the reference's pop of the repeated rows.
//
// What bounds it: the rows' scattered 64-byte gathers of Montgomery values
// (16 limbs at stride n) and the binary search's dependent loads, a few MB
// at u = 2^17; the single-block scan's 128 dependent tiles.  Each is far
// below a millisecond at the main path's size, against the host matching's
// 0.8 s it replaces, so nothing more is done about it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;  // 32 warps: the warp sums fill one warp
constexpr int kWords = 4;           // 64-bit words of a key, word 3 the most significant
constexpr int kLimbs = 16;
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  int64_t w[kWords];
};

// key j of a (4, u) array of words (each word's top limb biased, so signed
// order is the values' order)
__device__ __forceinline__ Key load_key(const int64_t* __restrict__ keys, int64_t u, int64_t j) {
  Key k;
#pragma unroll
  for (int w = 0; w < kWords; ++w) k.w[w] = keys[w * u + j];
  return k;
}

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
#pragma unroll
  for (int w = kWords - 1; w >= 0; --w) {
    if (a.w[w] != b.w[w]) return a.w[w] < b.w[w];
  }
  return false;
}

__device__ __forceinline__ bool key_equal(const Key& a, const Key& b) {
  bool eq = true;
#pragma unroll
  for (int w = 0; w < kWords; ++w) eq = eq && a.w[w] == b.w[w];
  return eq;
}

__global__ void __launch_bounds__(kThreads)
    lookup_first_kernel(const int64_t* __restrict__ keys_in, const int64_t* __restrict__ keys_tab,
                        const int64_t* __restrict__ idx_in, const int32_t* __restrict__ comp_input,
                        int32_t* __restrict__ perm_input, int32_t* __restrict__ perm_table,
                        uint8_t* __restrict__ first, uint8_t* __restrict__ used,
                        int32_t* __restrict__ missing, int64_t u, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= u) return;
  const Key k = load_key(keys_in, u, i);
  const bool is_first = i == 0 || !key_equal(k, load_key(keys_in, u, i - 1));
  first[i] = is_first;
  const int64_t src = idx_in[i];
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) {
    const int32_t v = comp_input[l * n + src];
    perm_input[l * n + i] = v;
    if (is_first) perm_table[l * n + i] = v;
  }
  if (!is_first) return;
  int64_t lo = 0, hi = u;  // the first table entry whose key is not below k
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (key_less(load_key(keys_tab, u, mid), k)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < u && key_equal(load_key(keys_tab, u, lo), k)) {
    used[lo] = 1;
  } else {
    *missing = 1;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    lookup_rank_kernel(const uint8_t* __restrict__ first, const uint8_t* __restrict__ used,
                       int32_t* __restrict__ rows, int32_t* __restrict__ left,
                       int32_t* __restrict__ counts, int64_t u) {
  __shared__ int32_t warp_rows[kScanThreads / 32];
  __shared__ int32_t warp_left[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t base_rows = 0, base_left = 0;
  for (int64_t t0 = 0; t0 < u; t0 += kScanThreads) {
    const int64_t i = t0 + threadIdx.x;
    const int32_t r = i < u && !first[i];
    const int32_t l = i < u && !used[i];
    int32_t sr = r, sl = l;  // inclusive scans within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t yr = __shfl_up_sync(kFull, sr, d);
      const int32_t yl = __shfl_up_sync(kFull, sl, d);
      if (lane >= d) {
        sr += yr;
        sl += yl;
      }
    }
    if (lane == 31) {
      warp_rows[warp] = sr;
      warp_left[warp] = sl;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the 32 warp sums
      int32_t wr = warp_rows[lane], wl = warp_left[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t yr = __shfl_up_sync(kFull, wr, d);
        const int32_t yl = __shfl_up_sync(kFull, wl, d);
        if (lane >= d) {
          wr += yr;
          wl += yl;
        }
      }
      warp_rows[lane] = wr;
      warp_left[lane] = wl;
    }
    __syncthreads();
    const int32_t off_rows = base_rows + (warp ? warp_rows[warp - 1] : 0) + sr - r;
    const int32_t off_left = base_left + (warp ? warp_left[warp - 1] : 0) + sl - l;
    if (r) rows[off_rows] = static_cast<int32_t>(i);
    if (l) left[off_left] = static_cast<int32_t>(i);
    base_rows += warp_rows[kScanThreads / 32 - 1];
    base_left += warp_left[kScanThreads / 32 - 1];
    __syncthreads();  // every thread has read the sums before the next tile writes them
  }
  if (threadIdx.x == 0) {
    counts[0] = base_rows;
    counts[1] = base_left;
  }
}

__global__ void __launch_bounds__(kThreads)
    lookup_fill_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ left,
                       const int32_t* __restrict__ counts, const int64_t* __restrict__ idx_tab,
                       const int32_t* __restrict__ comp_table, int32_t* __restrict__ perm_table,
                       int64_t u, int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int32_t num_rows = counts[0];
  // the two lengths differ only where a value is missing, and then the
  // caller raises; the guard keeps every index in range
  if (t >= u || t >= num_rows || t >= counts[1]) return;
  const int64_t row = rows[num_rows - 1 - t];
  const int64_t src = idx_tab[left[t]];
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) perm_table[l * n + row] = comp_table[l * n + src];
}

}  // namespace

// keys: (2, 4, u) int64, the sorted keys of the input (row 0) and the table
// (row 1); idx: (2, u) int64, their columns in comp_input / comp_table, (16,
// n) int32 Montgomery limbs.  Writes columns 0..u-1 of perm_input and
// perm_table (16, n).  Scratch: flags (2u bytes), ranks (2u int32); counts
// (3 int32) gets the repeated rows' count, the unused entries' count and the
// missing flag (1 where an input value is not in the table).  Launches on
// `stream` (two memsets, three kernels), allocates nothing, does not
// synchronise.
extern "C" int h2_lookup_match(const int64_t* keys, const int64_t* idx, const int32_t* comp_input,
                               const int32_t* comp_table, int32_t* perm_input,
                               int32_t* perm_table, uint8_t* flags, int32_t* ranks,
                               int32_t* counts, int64_t u, int64_t n, void* stream) {
  if (u <= 0 || u > n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* first = flags;
  uint8_t* used = flags + u;
  cudaError_t rc = cudaMemsetAsync(used, 0, static_cast<size_t>(u), s);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(counts + 2, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((u + kThreads - 1) / kThreads);
  lookup_first_kernel<<<blocks, kThreads, 0, s>>>(keys, keys + kWords * u, idx, comp_input,
                                                  perm_input, perm_table, first, used,
                                                  counts + 2, u, n);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  lookup_rank_kernel<<<1, kScanThreads, 0, s>>>(first, used, ranks, ranks + u, counts, u);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  lookup_fill_kernel<<<blocks, kThreads, 0, s>>>(ranks, ranks + u, counts, idx + u, comp_table,
                                                 perm_table, u, n);
  return static_cast<int>(cudaGetLastError());
}
