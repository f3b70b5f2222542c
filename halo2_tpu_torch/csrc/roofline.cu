// B1 / B2: the integer issue-rate loops of the roofline microbenchmark.
//
// Replace the Pallas kernels of bench_roofline.py: bench_vpu_mul (B1,
// y = y*x + x chained `iters` times, the u32 multiply-add rate) and
// bench_vpu_add (B2, y = (y + x) & 0xFFFF chained, the add/logic rate).
// On the TPU both ran over a (2048, 128) u32 block in VMEM; here one thread
// owns one element and keeps its chain in registers, so nothing but the
// loop touches memory between the first load and the last store.
//
// Bound: issue of the instruction being measured, by construction.  A step
// is one dependent instruction (B1: IMAD; its wide and high forms
// IMAD.WIDE.U32 and IMAD.HI.U32, the other multiplies of K1's CIOS loop) or
// two (B2: IADD3 + LOP3), and with 2^18 threads every SM holds 64 warps, 16
// per scheduler, enough to cover the chain's latency.  The loop is unrolled
// 16 times so that its counter, compare and branch are a small share of the
// issued instructions.  Each step is inline PTX in `asm volatile`, because
// both compilers rewrite plain code here: B2's recurrence is a 16-bit add
// whose closed form x*(k+1) mod 2^16 could replace the loop, and ptxas
// folds algebra across asm statements too (two xors with x cancel).  ptxas
// also moves a two-operand add to the multiply pipe as IMAD.IADD, which
// would make B2 a two-pipe measurement; a three-operand add is IADD3's
// alone, so B2 adds `zero`, a kernel argument that the launcher sets to 0
// and ptxas cannot see.  chip_smoke.py checks the built SASS for each loop
// body and its back branch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void int_muladd_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                                  int64_t n, int iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = static_cast<uint32_t>(x[i]);
  uint32_t acc = xv;
#pragma unroll 16
  for (int k = 0; k < iters; ++k) asm volatile("mad.lo.u32 %0, %0, %1, %1;" : "+r"(acc) : "r"(xv));
  y[i] = static_cast<int32_t>(acc);
}

// s = lo32(s) * x + s mod 2^64: one IMAD.WIDE.U32 a step (ptxas adds the
// high half of the addend with IADD3 / IADD3.X beside it); the output folds
// the two halves.
__global__ void int_muladd_wide_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                                       int64_t n, int iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = static_cast<uint32_t>(x[i]);
  uint64_t s = xv;
#pragma unroll 16
  for (int k = 0; k < iters; ++k) {
    const uint32_t lo = static_cast<uint32_t>(s);
    asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(s) : "r"(lo), "r"(xv));
  }
  y[i] = static_cast<int32_t>(static_cast<uint32_t>(s) ^ static_cast<uint32_t>(s >> 32));
}

// y = hi32(y * x) + x mod 2^32: one IMAD.HI.U32 a step.
__global__ void int_muladd_hi_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                                     int64_t n, int iters) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = static_cast<uint32_t>(x[i]);
  uint32_t acc = xv;
#pragma unroll 16
  for (int k = 0; k < iters; ++k) asm volatile("mad.hi.u32 %0, %0, %1, %1;" : "+r"(acc) : "r"(xv));
  y[i] = static_cast<int32_t>(acc);
}

__global__ void int_addmask_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                                   int64_t n, int iters, uint32_t zero) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = static_cast<uint32_t>(x[i]);
  uint32_t acc = xv;
#pragma unroll 16
  for (int k = 0; k < iters; ++k)
    asm volatile("add.u32 %0, %0, %1;\n\tadd.u32 %0, %0, %2;\n\tand.b32 %0, %0, 65535;"
                 : "+r"(acc)
                 : "r"(xv), "r"(zero));
  y[i] = static_cast<int32_t>(acc);
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// x, y: n int32 (u32 bit patterns) on the card; form 0 = IMAD, 1 = IMAD.WIDE,
// 2 = IMAD.HI.  Launch on `stream`, allocate nothing, do not synchronise.
extern "C" int h2_int_muladd(const int32_t* x, int32_t* y, int64_t n, int iters, int form,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (form == 1)
    int_muladd_wide_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, y, n, iters);
  else if (form == 2)
    int_muladd_hi_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, y, n, iters);
  else
    int_muladd_kernel<<<blocks_for(n), kThreads, 0, s>>>(x, y, n, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int h2_int_addmask(const int32_t* x, int32_t* y, int64_t n, int iters, void* stream) {
  int_addmask_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, iters, 0u);
  return static_cast<int>(cudaGetLastError());
}
