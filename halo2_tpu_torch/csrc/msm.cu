// K2 redesigned for the MSM: the three device passes of msm_many before its
// Horner fold (ops/msm.py), each one launch, with no (16, m, W, npad) select
// in device memory.
//
// Replace, in the JAX package's halo2_tpu/ops/msm.py, _signed_digits (with
// the Montgomery -> canonical multiply by 1 before it), _build_table, and
// _select_window_points + _fold_rows, whose every add is the Pallas kernel
// halo2_tpu/curves/pallas_ec.py _ec_add_pallas (K2) and whose T_2 is
// _ec_double_pallas (K3).  The JAX package runs all of it under one jit, so
// XLA fuses the digit loop, the where-chain select and the negation into the
// fold's launches; run eagerly, the same steps were ~1,000 torch dispatches
// per msm_many, and the select alone three (16, m, W, npad) int32 arrays
// (163 MB per column at n = 2^14).  The EC bodies are ec.cuh's, the product
// field.cuh's, so every output is bit-identical to the eager path's,
// projective limbs included.
//
//  - msm_digits_kernel: one thread per (column, point): Montgomery ->
//    canonical by mont_mul(a, 1), then _signed_digits' Booth recode over the
//    W windows in registers (a digit d >= 2^(c-1) becomes d - 2^c and carries
//    1; the top window takes the final carry unrecoded), the scalar shifted c
//    bits a window so no register array is indexed by a loop variable.
//    Points i >= n get digit 0, so no launch reads a padded scalar or point.
//    Bound by bytes (32 B in, 2W B out per point) at the main path's widths.
//  - ec_window_table_kernel: one thread per point, the chain T_0 = identity,
//    T_1 = P, T_2 = 2P, T_j = T_(j-1) + P in registers (_build_table's
//    operand order), written point-major: entry j of point i is one
//    contiguous 96-byte record (x, y, z as 8 words each) at (i (h+1) + j) 96,
//    so the fold's scattered per-thread reads are six 16-byte loads.  A
//    dependent chain of h-1 EC operations per thread: latency-bound, like
//    ec.cu's chains.
//  - ec_window_fold_kernel: grid (rows = m W) x nb blocks of T threads, nb =
//    count / T.  Thread k of block (row, j) takes element i = j + k nb: in
//    the first pass the table record T_i[|d|] picked by its digit (y negated
//    for d < 0, 0 -> 0 as limb.fneg; T_0 = (0, R, 0) for i >= n), in later
//    passes the previous pass's partial i.  The block then runs the
//    stride-halving tree s[k] = s[k] + s[k + stride] through shared memory
//    and writes one partial, or, when nb = 1, the window sum in (16, rows)
//    limb layout for ec_horner.  The strided membership makes level l of the
//    block tree pair exactly what level l of _fold_points' global halving
//    fold pairs (i with i + count / 2^l, the lower index first), and each
//    later pass repeats the remaining levels, so the sums equal the eager
//    fold limb for limb.  Shared memory holds 24 words a thread, word-major
//    (sh[word][k]), so a warp's accesses hit 32 distinct banks.  What bounds
//    it: the adds' 32-bit multiply-adds (12 products of 136 each) at full
//    occupancy, the dependent latency of each add where few warps are
//    resident (ptxas gives this kernel 112 registers, so an SM holds four
//    of its 128-thread blocks) and in the tree's last levels, where half the
//    threads idle at each level.  The block is 128 threads: faster than 256
//    at one column and at the IPA's shapes, 7% slower at seven columns
//    (PERF.md).  Blocks are numbered with the row fastest, so the blocks
//    resident at once read the same points' table records from L2.
#include <cuda_runtime.h>

#include "ec.cuh"

namespace {

using h2::Modulus;
using h2::NW;

constexpr int kRec = 3 * NW;  // words of one (x, y, z) record

struct Words {
  uint32_t w[NW];
};

Modulus make_modulus(const uint32_t* p_words, uint32_t n0) {
  Modulus m;
  for (int j = 0; j < NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  return m;
}

Words make_words(const uint32_t* words) {
  Words w;
  for (int j = 0; j < NW; ++j) w.w[j] = words[j];
  return w;
}

__device__ __forceinline__ void unpack4(uint32_t* w, uint4 q) {
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}

// One 96-byte record (16-byte aligned) -> three coordinates.
__device__ __forceinline__ void get_point(const uint32_t* __restrict__ rec, uint32_t X[NW],
                                          uint32_t Y[NW], uint32_t Z[NW]) {
  const uint4* v = reinterpret_cast<const uint4*>(rec);
  unpack4(X, v[0]);
  unpack4(X + 4, v[1]);
  unpack4(Y, v[2]);
  unpack4(Y + 4, v[3]);
  unpack4(Z, v[4]);
  unpack4(Z + 4, v[5]);
}

__device__ __forceinline__ void put_point(uint32_t* __restrict__ rec, const uint32_t X[NW],
                                          const uint32_t Y[NW], const uint32_t Z[NW]) {
  uint4* v = reinterpret_cast<uint4*>(rec);
  v[0] = make_uint4(X[0], X[1], X[2], X[3]);
  v[1] = make_uint4(X[4], X[5], X[6], X[7]);
  v[2] = make_uint4(Y[0], Y[1], Y[2], Y[3]);
  v[3] = make_uint4(Y[4], Y[5], Y[6], Y[7]);
  v[4] = make_uint4(Z[0], Z[1], Z[2], Z[3]);
  v[5] = make_uint4(Z[4], Z[5], Z[6], Z[7]);
}

__device__ __forceinline__ void set_identity(uint32_t X[NW], uint32_t Y[NW], uint32_t Z[NW],
                                             const Words& one) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    X[j] = 0;
    Y[j] = one.w[j];
    Z[j] = 0;
  }
}

constexpr int kDigitThreads = 128;

// scalars: (m, 16, n) Montgomery limbs of the scalar field, column j's limb l
// of point i at j * col_stride + l * ld + i; out: (m, W, npad) int16 digits.
// One thread per (column, point of npad).
__global__ void __launch_bounds__(kDigitThreads)
    msm_digits_kernel(const int32_t* __restrict__ scalars, int16_t* __restrict__ out, int64_t m,
                      int64_t n, int64_t npad, int64_t col_stride, int64_t ld, int c, int windows,
                      Modulus mod) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= m * npad) return;
  const int64_t col = t / npad;
  const int64_t i = t - col * npad;
  int16_t* dst = out + col * windows * npad + i;
  if (i >= n) {
#pragma unroll 1
    for (int w = 0; w < windows; ++w) dst[w * npad] = 0;
    return;
  }
  uint32_t s[NW], one[NW];
  h2::load(s, scalars + col * col_stride, ld, i);
#pragma unroll
  for (int j = 0; j < NW; ++j) one[j] = j == 0 ? 1u : 0u;
  h2::mont_mul(s, s, one, mod);  // canonical
  const uint32_t mask = (1u << c) - 1u;
  const int half = 1 << (c - 1);
  int carry = 0;
#pragma unroll 1
  for (int w = 0; w < windows; ++w) {
    const int v = static_cast<int>(s[0] & mask) + carry;
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) s[j] = __funnelshift_r(s[j], s[j + 1], c);
    s[NW - 1] >>= c;
    int d = v;
    if (w < windows - 1) {
      carry = v >= half ? 1 : 0;
      d = carry ? v - (1 << c) : v;
    }
    dst[w * npad] = static_cast<int16_t>(d);
  }
}

constexpr int kTableThreads = 64;

// (px, py, pz): (16, n) base-field Montgomery limbs, limb l of point i at
// l * ld + i; table: n * (h + 1) records of kRec words.
__global__ void __launch_bounds__(kTableThreads)
    ec_window_table_kernel(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
                           const int32_t* __restrict__ pz, uint32_t* __restrict__ table,
                           int64_t n, int64_t ld, int h, Modulus mod, uint32_t b3, Words one) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t PX[NW], PY[NW], PZ[NW], AX[NW], AY[NW], AZ[NW];
  h2::load(PX, px, ld, i);
  h2::load(PY, py, ld, i);
  h2::load(PZ, pz, ld, i);
  uint32_t* rec = table + i * (h + 1) * kRec;
  set_identity(AX, AY, AZ, one);
  put_point(rec, AX, AY, AZ);
  put_point(rec + kRec, PX, PY, PZ);
  if (h < 2) return;
  h2::ec_double(AX, AY, AZ, PX, PY, PZ, mod, b3);
  put_point(rec + 2 * kRec, AX, AY, AZ);
#pragma unroll 1
  for (int j = 3; j <= h; ++j) {
    h2::ec_add(AX, AY, AZ, AX, AY, AZ, PX, PY, PZ, mod, b3);
    put_point(rec + j * kRec, AX, AY, AZ);
  }
}

// One pass of the window fold.  digits != nullptr: the first pass, src the
// table (n records of h1 entries), count = npad, digits (rows, npad).
// digits == nullptr: a later pass, src the partials (rows, count) records.
// The block's T = blockDim.x <= kFoldThreads threads fold T elements; dst
// (rows, nb) records, or, when dst == nullptr (nb = 1), (ox, oy, oz) (16,
// rows) limb arrays.
constexpr int kFoldThreads = 128;

__global__ void __launch_bounds__(kFoldThreads)
    ec_window_fold_kernel(const int16_t* __restrict__ digits, const uint32_t* __restrict__ src,
                          uint32_t* __restrict__ dst, int32_t* __restrict__ ox,
                          int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t rows,
                          int64_t count, int64_t nb, int64_t n, int h1, Modulus mod, uint32_t b3,
                          Words one) {
  __shared__ uint32_t sh[kRec][kFoldThreads];
  const int64_t row = blockIdx.x % rows;  // rows fastest: resident blocks share points
  const int64_t j = blockIdx.x / rows;
  const int k = threadIdx.x;
  const int64_t i = j + static_cast<int64_t>(k) * nb;
  uint32_t X[NW], Y[NW], Z[NW];
  if (digits == nullptr) {
    get_point(src + (row * count + i) * kRec, X, Y, Z);
  } else if (i < n) {
    const int d = digits[row * count + i];
    get_point(src + (i * h1 + (d < 0 ? -d : d)) * kRec, X, Y, Z);
    if (d < 0) {
      uint32_t zero[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) zero[w] = 0;
      h2::sub(Y, zero, Y, mod);  // p - y, and 0 -> 0
    }
  } else {
    set_identity(X, Y, Z, one);
  }
  // Level by level the upper half [stride, 2 stride) publishes its point and
  // the lower half adds it to its own, which stays in registers.  The next
  // level's writers [stride/2, stride) touch no slot this level reads, so
  // one barrier a level suffices.
#pragma unroll 1
  for (int stride = blockDim.x >> 1; stride > 0; stride >>= 1) {
    if (k >= stride && k < 2 * stride) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        sh[w][k] = X[w];
        sh[NW + w][k] = Y[w];
        sh[2 * NW + w][k] = Z[w];
      }
    }
    __syncthreads();
    if (k < stride) {
      uint32_t QX[NW], QY[NW], QZ[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        QX[w] = sh[w][k + stride];
        QY[w] = sh[NW + w][k + stride];
        QZ[w] = sh[2 * NW + w][k + stride];
      }
      h2::ec_add(X, Y, Z, X, Y, Z, QX, QY, QZ, mod, b3);
    }
  }
  if (k != 0) return;
  if (dst != nullptr) {
    put_point(dst + (row * nb + j) * kRec, X, Y, Z);
  } else {
    h2::store(ox, rows, row, X);
    h2::store(oy, rows, row, Y);
    h2::store(oz, rows, row, Z);
  }
}

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// scalars: (m, 16, n) int32 Montgomery limbs in the scalar field (r_words,
// n0), strides (col_stride, ld, 1); out: (m, windows, npad) int16; 1 <= c <=
// 8.  Launch on `stream`, allocate nothing, do not synchronise.
extern "C" int h2_msm_digits(const int32_t* scalars, int16_t* out, int64_t m, int64_t n,
                             int64_t npad, int64_t col_stride, int64_t ld, int64_t c,
                             int64_t windows, const uint32_t* r_words, uint32_t n0,
                             void* stream) {
  if (c < 1 || c > 8 || npad < n) return static_cast<int>(cudaErrorInvalidValue);
  msm_digits_kernel<<<blocks_for(m * npad, kDigitThreads), kDigitThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      scalars, out, m, n, npad, col_stride, ld, static_cast<int>(c), static_cast<int>(windows),
      make_modulus(r_words, n0));
  return static_cast<int>(cudaGetLastError());
}

// points: three (16, n) int32 limb arrays in the base field (p_words, n0),
// row stride ld; table: n * (h + 1) * 24 words; one_words: R mod p.
extern "C" int h2_ec_window_table(const int32_t* px, const int32_t* py, const int32_t* pz,
                                  int32_t* table, int64_t n, int64_t ld, int64_t h,
                                  const uint32_t* p_words, uint32_t n0, uint32_t b3,
                                  const uint32_t* one_words, void* stream) {
  ec_window_table_kernel<<<blocks_for(n, kTableThreads), kTableThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, reinterpret_cast<uint32_t*>(table), n, ld, static_cast<int>(h),
      make_modulus(p_words, n0), b3, make_words(one_words));
  return static_cast<int>(cudaGetLastError());
}

// One fold pass over rows x count elements with `threads` (a power of two
// dividing count, at most 128) threads a block.  digits null: src holds
// partials.  dst null: the last pass, into (ox, oy, oz).
extern "C" int h2_ec_window_fold(const int16_t* digits, const int32_t* src, int32_t* dst,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t rows,
                                 int64_t count, int64_t n, int64_t h1, int64_t threads,
                                 const uint32_t* p_words, uint32_t n0, uint32_t b3,
                                 const uint32_t* one_words, void* stream) {
  if (threads < 1 || threads > kFoldThreads || count % threads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = count / threads;
  ec_window_fold_kernel<<<static_cast<unsigned>(rows * nb), static_cast<unsigned>(threads), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      digits, reinterpret_cast<const uint32_t*>(src), reinterpret_cast<uint32_t*>(dst), ox, oy,
      oz, rows, count, nb, n, static_cast<int>(h1), make_modulus(p_words, n0), b3,
      make_words(one_words));
  return static_cast<int>(cudaGetLastError());
}
