// K1: elementwise Montgomery product out = a * b * 2^-256 mod p.
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
