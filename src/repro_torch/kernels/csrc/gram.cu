// Gram matrix G (k, k) = Xᵀ X of a tall-skinny factor panel X (r, k) on
// Hopper (sm_90a) — the products HHᵀ (X = Hᵀ) and WᵀW of every iteration.
//
// Replaces the TPU kernel `_gram_kernel` / `gram` of
// src/repro/kernels/gram.py (pallas_call at :42).
//
// Bound at the main path's shapes (H100 SXM, fp32): XᵀX is symmetric, so
// gram(W) with r = 1,013,400 and k = 50 needs r·k·(k+1) = 2.58 GFLOP
// (0.039 ms at 67 TFLOP/s) and reads 0.20 GB (0.061 ms at 3.35 TB/s):
// bound by bytes at 0.061 ms.  gram(Hᵀ) with r = 13,824 is a few
// microseconds of work: launch-bound.
//
// Design against that bound:
//  * The Pallas kernel carries one k×k accumulator across a sequential grid
//    over row panels.  Hopper blocks run in no order, so the rows are split
//    into S slabs instead (blockIdx.z); each block accumulates a 64×64 tile
//    of its slab's partial Gram in registers (4×4 per thread) and writes it
//    to scratch (S, k, k).  slab_reduce_kernel sums the partials in a fixed
//    order: no atomics, reproducible runs.  Enough slabs are used to put
//    several blocks on every SM, which is what r ≈ 1 M needs.
//  * X is read once per output tile; for k ≤ 64 (the paper's k = 50) that
//    is once.  k is tiled by 64 over blockIdx.x/y, so any k works.
//  * Ragged rows and columns are masked inside the kernel; X is not padded.
//  * G[a][b] and G[b][a] come from the same products summed in the same
//    order, so the result is exactly symmetric.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int GT = 64;        // output tile edge
constexpr int GK = 32;        // rows per shared-memory stage
constexpr int GTM = 4;        // outputs per thread along each edge
constexpr int THREADS = (GT / GTM) * (GT / GTM);   // 256

static_assert((GK * GT) % THREADS == 0, "tiles");

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ X, float* __restrict__ out, int64_t r,
            int64_t k, int64_t slab) {
  __shared__ __align__(16) float Xa[GK][GT];
  __shared__ __align__(16) float Xb[GK][GT];

  const int tid = threadIdx.x;
  const int tx = tid % (GT / GTM);
  const int ty = tid / (GT / GTM);
  const int64_t a0 = (int64_t)blockIdx.x * GT;
  const int64_t b0 = (int64_t)blockIdx.y * GT;
  const int64_t d_begin = (int64_t)blockIdx.z * slab;
  const int64_t d_end = d_begin + slab < r ? d_begin + slab : r;
  float* dst = out + (int64_t)blockIdx.z * k * k;

  float acc[GTM][GTM];
#pragma unroll
  for (int i = 0; i < GTM; ++i)
#pragma unroll
    for (int j = 0; j < GTM; ++j) acc[i][j] = 0.f;

  for (int64_t d0 = d_begin; d0 < d_end; d0 += GK) {
#pragma unroll
    for (int it = 0; it < (GK * GT) / THREADS; ++it) {
      const int l = it * THREADS + tid;
      const int c = l % GT;
      const int d = l / GT;
      const int64_t gd = d0 + d;
      const bool row_ok = gd < d_end;
      const T* xrow = X + gd * k;
      Xa[d][c] = (row_ok && a0 + c < k) ? to_f32(xrow[a0 + c]) : 0.f;
      Xb[d][c] = (row_ok && b0 + c < k) ? to_f32(xrow[b0 + c]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&Xa[kk][ty * GTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Xb[kk][tx * GTM]);
      const float a[GTM] = {av.x, av.y, av.z, av.w};
      const float b[GTM] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < GTM; ++i)
#pragma unroll
        for (int j = 0; j < GTM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GTM; ++i) {
    const int64_t ga = a0 + ty * GTM + i;
    if (ga >= k) continue;
#pragma unroll
    for (int j = 0; j < GTM; ++j) {
      const int64_t gb = b0 + tx * GTM + j;
      if (gb < k) dst[ga * k + gb] = acc[i][j];
    }
  }
}

}  // namespace

// The tile sizes the wrapper plans its slabs with: (output tile edge, rows
// per stage).
extern "C" int gram_tiles(int* out) {
  out[0] = GT;
  out[1] = GK;
  return 0;
}

// G (k, k) fp32 = Xᵀ X for X (r, k) contiguous.  With slabs > 1 the slab
// partials go to scratch (slabs, k, k) and are then reduced into G.
extern "C" int gram_launch(int dtype, const void* X, void* G, void* scratch,
                           int64_t r, int64_t k, int64_t slab, int64_t slabs,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slabs > 1 ? scratch : G);
  const unsigned tiles = (unsigned)((k + GT - 1) / GT);
  const dim3 grid(tiles, tiles, (unsigned)slabs);
  if (dtype == repro_torch::kF32) {
    gram_kernel<float><<<grid, THREADS, 0, s>>>(static_cast<const float*>(X),
                                                dst, r, k, slab);
  } else if (dtype == repro_torch::kBF16) {
    gram_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(X), dst, r, k, slab);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)repro_torch::launch_slab_reduce(dst, static_cast<float*>(G),
                                              k * k, slabs, s);
}
