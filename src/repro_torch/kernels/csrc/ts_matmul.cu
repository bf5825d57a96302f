// Tall-skinny products of the AU-NMF iteration on Hopper (sm_90a):
//
//   ts_matmul    C (m, k) = A (m, n) · B (n, k)    — the W-step product A·Hᵀ
//   ts_matmul_t  Y (n, k) = Aᵀ · B, B (m, k)       — the H-step product AᵀW,
//                contracting A's rows so Aᵀ is never materialised
//
// Replaces the TPU kernels `_ab_kernel` / `ts_matmul` and `_atb_kernel` /
// `ts_matmul_t` of src/repro/kernels/ts_matmul.py (pallas_call at :44, :76).
//
// Bound at the main path's shape (m = 1,013,400, n = 13,824, k = 50, fp32,
// H100 SXM): 2·m·n·k = 1.40 TFLOP over the 67 TFLOP/s of fp32 outside the
// tensor cores is 20.9 ms; reading A's 56.0 GB once at 3.35 TB/s is 16.7 ms.
// So fp32 is compute-bound, and must stay exact fp32 (no TF32).  For bf16 A
// the bytes halve; these kernels still multiply in fp32 on the CUDA cores.
//
// Design against that bound:
//  * A is read exactly once.  Each block owns one BM-row tile of the output
//    and loops over the whole contraction inside the block (the Pallas grid's
//    sequential accumulation axis becomes this in-block loop).  A and B tiles
//    are staged through shared memory; the (BM × BN) output tile stays in
//    registers, TM × TN = 8 × 4 per thread, so each A value read from shared
//    memory feeds 4 FMAs and each B value 8.
//  * k is tiled by BN = 64 over blockIdx.y, so any k works; k = 50 uses one
//    tile and spends 14/64 of the FMAs on masked columns.
//  * ts_matmul_t contracts over m ≈ 1 M rows, and a grid over n-tiles alone
//    has only ~108 blocks.  So m is split into S slabs (blockIdx.z), each
//    block writes an fp32 (n-tile × k) partial to scratch (S, n, k), and
//    slab_reduce_kernel sums the partials in a fixed order.  No atomics.
//  * Ragged edges (rows, contraction, k) are masked inside the kernel: A is
//    never padded or copied.  Loads are scalar and coalesced along A's rows,
//    so no alignment of n or m is required.
//  * Each thread loads the next stage's A and B elements into registers
//    while it runs the current stage's FMAs from shared memory, so the loads
//    of A overlap the arithmetic without a second shared-memory buffer.
//  * Simple first: no cp.async/TMA pipelining and no tensor cores; those are
//    later work and are measured against this version.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int BM = 128;     // output rows per block
constexpr int BN = 64;      // output columns (of k) per block
constexpr int BK = 32;      // contraction depth per shared-memory stage
constexpr int TM = 8;       // output rows per thread
constexpr int TN = 4;       // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int AS_LD = BM + 4;                    // keeps float4 reads aligned

static_assert(THREADS == 256, "tile shape");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0, "tiles");

// out[z] (rows, k) = sum over d in slab z of op(A)[r, d] · B[d, c], where
// op(A)[r, d] = A[r * lda + d] (TRANS = false) or A[d * lda + r] (TRANS).
// B is (depth, k) row-major.  Slab z covers d in [z·slab, (z+1)·slab).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS, 2)
skinny_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     float* __restrict__ out, int64_t rows, int64_t depth,
                     int64_t k, int64_t lda, int64_t slab) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;
  const int64_t d_begin = (int64_t)blockIdx.z * slab;
  const int64_t d_end = d_begin + slab < depth ? d_begin + slab : depth;
  float* dst = out + (int64_t)blockIdx.z * rows * k;

  // The A elements this thread stages, (a_r + it·A_RSTEP, a_d + it·A_DSTEP)
  // for it < A_LOADS.  ts_matmul: a warp reads 4 rows × 8 consecutive
  // elements of A (full 32-byte sectors) and stores them to As without bank
  // conflicts; ts_matmul_t: a warp reads 32 consecutive elements of a row.
  constexpr int A_LOADS = BM * BK / THREADS;                // 16
  constexpr int A_RSTEP = TRANS ? 0 : THREADS / BK;         // 8 rows
  constexpr int A_DSTEP = TRANS ? THREADS / BM : 0;         // 2 rows of A
  const int a_r = TRANS ? tid % BM : (warp / 4) * 4 + lane / 8;
  const int a_d = TRANS ? tid / BM : (warp % 4) * 8 + lane % 8;
  const int64_t a_step = TRANS ? A_DSTEP * lda : A_RSTEP * lda;
  const T* a_ptr = TRANS ? A + (d_begin + a_d) * lda + row0 + a_r
                         : A + (row0 + a_r) * lda + d_begin + a_d;
  // The B elements: column b_c, rows b_d + it·B_DSTEP for it < B_LOADS.
  constexpr int B_LOADS = BK * BN / THREADS;                // 8
  constexpr int B_DSTEP = THREADS / BN;                     // 4
  const int b_c = tid % BN;
  const int b_d = tid / BN;
  const bool b_ok = col0 + b_c < k;
  const T* b_ptr = B + (d_begin + b_d) * k + col0 + b_c;

  float a_reg[A_LOADS], b_reg[B_LOADS];
  // Global -> registers for the stage starting at d0 (masked at the edges).
  auto load = [&](int64_t d0) {
    const int64_t off = d0 - d_begin;
    const T* pa = a_ptr + (TRANS ? off * lda : off);
    const T* pb = b_ptr + off * k;
#pragma unroll
    for (int it = 0; it < A_LOADS; ++it) {
      const bool ok = row0 + a_r + it * A_RSTEP < rows &&
                      d0 + a_d + it * A_DSTEP < d_end;
      a_reg[it] = ok ? to_f32(pa[it * a_step]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < B_LOADS; ++it) {
      const bool ok = b_ok && d0 + b_d + it * B_DSTEP < d_end;
      b_reg[it] = ok ? to_f32(pb[(int64_t)it * B_DSTEP * k]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if (d_begin < d_end) load(d_begin);
  for (int64_t d0 = d_begin; d0 < d_end; d0 += BK) {
#pragma unroll
    for (int it = 0; it < A_LOADS; ++it)
      As[a_d + it * A_DSTEP][a_r + it * A_RSTEP] = a_reg[it];
#pragma unroll
    for (int it = 0; it < B_LOADS; ++it) Bs[b_d + it * B_DSTEP][b_c] = b_reg[it];
    __syncthreads();
    // The next stage's loads are in flight while this stage's FMAs run.
    if (d0 + BK < d_end) load(d0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gr = row0 + ty * TM + i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gc = col0 + tx * TN + j;
      if (gc < k) dst[gr * k + gc] = acc[i][j];
    }
  }
}

template <bool TRANS>
cudaError_t launch(int dtype, const void* A, const void* B, float* out,
                   int64_t rows, int64_t depth, int64_t k, int64_t lda,
                   int64_t slab, int64_t slabs, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + BM - 1) / BM),
                  (unsigned)((k + BN - 1) / BN), (unsigned)slabs);
  if (dtype == repro_torch::kF32) {
    skinny_matmul_kernel<float, TRANS><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), out, rows,
        depth, k, lda, slab);
  } else if (dtype == repro_torch::kBF16) {
    skinny_matmul_kernel<__nv_bfloat16, TRANS><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), out, rows, depth, k, lda, slab);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The tile sizes the wrapper plans its slabs with: (rows, columns of k,
// contraction depth per stage) of a block.
extern "C" int ts_matmul_tiles(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  return 0;
}

// C (m, k) fp32 = A (m, n) · B (n, k); A and B contiguous, same dtype.
extern "C" int ts_matmul_launch(int dtype, const void* A, const void* B,
                                void* C, int64_t m, int64_t n, int64_t k,
                                void* stream) {
  return (int)launch<false>(dtype, A, B, static_cast<float*>(C), m, n, k, n,
                            n, 1, static_cast<cudaStream_t>(stream));
}

// Y (n, k) fp32 = Aᵀ · B for A (m, n), B (m, k).  With slabs > 1 the slab
// partials go to scratch (slabs, n, k) and are then reduced into Y.
extern "C" int ts_matmul_t_launch(int dtype, const void* A, const void* B,
                                  void* Y, void* scratch, int64_t m,
                                  int64_t n, int64_t k, int64_t slab,
                                  int64_t slabs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slabs > 1 ? scratch : Y);
  cudaError_t err = launch<true>(dtype, A, B, dst, n, m, k, n, slab, slabs, s);
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)repro_torch::launch_slab_reduce(dst, static_cast<float*>(Y),
                                              n * k, slabs, s);
}
