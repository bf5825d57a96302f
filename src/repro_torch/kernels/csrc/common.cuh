// Shared pieces of the port's CUDA kernels: input loads in fp32 or bf16,
// and the fixed-order reduction of per-slab partial sums.
//
// Kernels that contract over a long axis (ts_matmul_t over m, gram over the
// factor's rows) split that axis into S slabs, one block column each, and
// write an fp32 partial per slab.  slab_reduce_kernel then sums the S
// partials of every output element in the order s = 0, 1, ..., S-1.  No
// atomics: the result does not depend on which block ran first, so runs are
// reproducible bit for bit.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Input dtype codes, as passed by kernels/ops.py.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// out[e] = sum over s of part[s * len + e], for e < len.
__global__ void slab_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int64_t len,
                                   int64_t slabs) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < len;
       e += stride) {
    float acc = 0.f;
    for (int64_t s = 0; s < slabs; ++s) acc += part[s * len + e];
    out[e] = acc;
  }
}

inline cudaError_t launch_slab_reduce(const float* part, float* out,
                                      int64_t len, int64_t slabs,
                                      cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (len + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;  // the grid-stride loop covers the rest
  slab_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, len,
                                                               slabs);
  return cudaGetLastError();
}

}  // namespace repro_torch

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
