// K1's field entries: out = a + b, a - b (mod p) and p - a (0 -> 0), one
// launch each.
//
// On the TPU these are no kernel of their own: the JAX package jits each of
// fields/limb.py fadd / fsub / fneg into one fused XLA program beside the
// Pallas product mont_mul_rows (halo2_tpu/fields/pallas_kernels.py:129),
// whose 8-word form (field.cuh) they share here.  Without them the port ran
// each as its 16-step carry or borrow chain of eager torch ops: 134, 165 and
// 86 launches a call, most of the launches of a prove.
//
// One thread per element over (16, n) int32 limb arrays, packed to 8 words at
// the load as K1 does.  An operand of one element (a challenge or a constant
// of the quotient, (16, 1)) is read with element stride 0 instead of being
// expanded to n elements.  Each thread reads 128 bytes (64 with a broadcast
// operand, 64 for the negation) and writes 64 for a few dozen 32-bit adds, so
// the kernel is bound by device-memory bandwidth; the loads and stores are
// coalesced (limb l of neighbouring elements are neighbouring words) and
// nothing else is done about it.  h2::add and h2::sub return the unique value
// in [0, p) for inputs in [0, p), so the result equals the plain chains limb
// for limb.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum Op { kAdd = 0, kSub = 1, kNeg = 2 };

// limb l of element i at ptr[l * limb_stride + i * elem_stride]
struct Operand {
  const int32_t* ptr;
  int64_t limb_stride;
  int64_t elem_stride;  // 1, or 0 for a broadcast element
};

constexpr int kThreads = 256;

template <int kOp>
__global__ void __launch_bounds__(kThreads)
    field_op_kernel(Operand a, Operand b, int32_t* __restrict__ out, int64_t n, h2::Modulus m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[h2::NW], y[h2::NW];
  h2::load_strided(x, a.ptr, a.limb_stride, i * a.elem_stride);
  if (kOp == kNeg) {
#pragma unroll
    for (int j = 0; j < h2::NW; ++j) y[j] = 0;
    h2::sub(x, y, x, m);  // 0 - a: p - a, and 0 for a = 0
  } else {
    h2::load_strided(y, b.ptr, b.limb_stride, i * b.elem_stride);
    if (kOp == kAdd) {
      h2::add(x, x, y, m);
    } else {
      h2::sub(x, x, y, m);
    }
  }
  h2::store(out, n, i, x);
}

}  // namespace

// op: 0 add, 1 sub, 2 neg (b is not read).  out is (16, n) contiguous.
// p_words: 8 little-endian 32-bit words of p (host memory); n0 = -p^-1 mod 2^32.
// Launches on `stream`, allocates nothing, does not synchronise.
extern "C" int h2_field_op(int64_t op, const int32_t* a, int64_t a_limb_stride,
                           int64_t a_elem_stride, const int32_t* b, int64_t b_limb_stride,
                           int64_t b_elem_stride, int32_t* out, int64_t n,
                           const uint32_t* p_words, uint32_t n0, void* stream) {
  h2::Modulus m;
  for (int j = 0; j < h2::NW; ++j) m.p[j] = p_words[j];
  m.n0 = n0;
  const Operand x{a, a_limb_stride, a_elem_stride};
  const Operand y{b, b_limb_stride, b_elem_stride};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAdd:
      field_op_kernel<kAdd><<<blocks, kThreads, 0, s>>>(x, y, out, n, m);
      break;
    case kSub:
      field_op_kernel<kSub><<<blocks, kThreads, 0, s>>>(x, y, out, n, m);
      break;
    case kNeg:
      field_op_kernel<kNeg><<<blocks, kThreads, 0, s>>>(x, y, out, n, m);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
