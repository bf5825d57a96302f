// Shared pieces of the port's CUDA kernels: input loads in fp32 or bf16,
// the fixed-order reductions of per-slab partial sums, asynchronous copies
// into shared memory, and the 3xTF32 split.
//
// Kernels that contract over a long axis (ts_matmul_t over m, ts_matmul
// over n when its output is short, gram over the factor's rows) split that
// axis into S slabs, one block column each, and write an fp32 partial per
// slab.  slab_reduce_warp_kernel (a warp per element) then sums the S
// partials of every output element in a fixed order (gram has its own).  No atomics: the result does not
// depend on which block ran first, so runs are reproducible bit for bit.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Input dtype codes, as passed by kernels/ops.py.
enum DType : int { kF32 = 0, kBF16 = 1 };

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// out[e] = sum over s of part[s * len + e], one warp per element: lane l
// adds slabs l, l + 32, ... in order, then the lanes combine in a fixed
// butterfly.  Its parallelism covers the slab axis, so a short output with
// hundreds of slabs (the split contraction of a short-wide product) does
// not leave a few threads summing serially.  Deterministic.
__global__ void slab_reduce_warp_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int64_t len,
                                        int64_t slabs) {
  const int lane = threadIdx.x % 32;
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (e >= len) return;
  float acc = 0.f;
  for (int64_t s = lane; s < slabs; s += 32) acc += part[s * len + e];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[e] = acc;
}

inline cudaError_t launch_slab_reduce_warp(const float* part, float* out,
                                           int64_t len, int64_t slabs,
                                           cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (len * 32 + threads - 1) / threads;
  slab_reduce_warp_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      part, out, len, slabs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Asynchronous global -> shared copies (cp.async, sm_80+).
//
// A copy of `bytes` contiguous bytes starting at global address `src` into
// shared memory at `dst` is words_for() W-byte cp.async copies (W = 16 or
// 4), word j copied by copy_word(); the threads of a block share the words.
// The copies start at src rounded down to W, so dst receives
// (src mod W) bytes before the first wanted byte: the caller reads element
// e of the range at dst + (src mod W) + e·size.  Only bytes below
// src + valid are read from global memory; the rest of each word, and whole
// words past it, are zero-filled (cp.async's src-size operand), so a ragged
// tail or a row past the end of the matrix arrives as zeros.  The
// rounded-down word never leaves the 4- or 16-byte granule that holds the
// first wanted byte, so no read crosses an allocation.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Word j of the copy of [src, src + valid) in W-byte words: its global
// address and how many of its bytes are real (0..W).
template <int W>
__device__ __forceinline__ int word_bytes(uintptr_t src, int64_t valid,
                                          int64_t j, uintptr_t* addr) {
  const uintptr_t a = (src & ~(uintptr_t)(W - 1)) + (uintptr_t)j * W;
  *addr = a;
  if (valid <= 0) return 0;   // no real byte: not even the lead-in is read
  const int64_t left = (int64_t)(src + valid) - (int64_t)a;
  return left <= 0 ? 0 : (left >= W ? W : (int)left);
}

// Words needed to cover `bytes` bytes starting at `src`.
template <int W>
__device__ __forceinline__ int64_t words_for(uintptr_t src, int64_t bytes) {
  return ((int64_t)(src & (W - 1)) + bytes + W - 1) / W;
}

// One W-byte word of such a copy.  A word with no real byte still copies
// (zeros) but reads from `fallback`, an address that is always valid.
template <int W>
__device__ __forceinline__ void copy_word(char* dst, uintptr_t src,
                                          int64_t valid, int64_t j,
                                          const void* fallback) {
  uintptr_t a;
  const int n = word_bytes<W>(src, valid, j, &a);
  const void* from = n ? reinterpret_cast<const void*>(a) : fallback;
  if (W == 16)
    cp_async16(dst + j * W, from, n);
  else
    cp_async4(dst + j * W, from, n);
}

// ---------------------------------------------------------------------------
// 3xTF32: an fp32 value x as big + small, both tf32 (10-bit mantissa).
// big rounds x to nearest (ties away) by clearing 13 mantissa bits; small =
// x − big is exact in fp32 and the tensor core reads its top 10 mantissa
// bits, so big + small keeps x to 2^-22 relative.  big·big + big·small +
// small·big then matches an fp32 product to about that (the dropped
// small·small is below 2^-22 of it).  A NaN or infinite x gives a NaN
// small, so the products come out NaN, as an fp32 product with a NaN would.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

}  // namespace repro_torch

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
