// Sparse × dense products of the sparse path on Hopper (sm_90a): out (m, k)
// fp32 = A · B for A as COO triplets (vals, rows, cols) and a dense B (n, k),
// B and vals in fp32 or bf16, sums in fp32.  Aᵀ·B is the same call with rows
// and cols swapped (unsorted) or on the column-sorted copy (sorted).
//
// Replaces the TPU kernels of src/repro/kernels/spmm.py:
//  * spmm_kernel        <- `_spmm_kernel` / `spmm` (pallas_call at :99);
//  * spmm_sorted_kernel <- `_spmm_sorted_kernel` / `spmm_sorted` (:189).
//
// Bound at the sparse path's full size (m = n = 2^24, k = 50, nnz = 144.8 M,
// H100 SXM, fp32): the compulsory bytes are the triplets once (1.74 GB), B
// once (3.36 GB) and the output once (3.36 GB): 8.45 GB, 2.52 ms at
// 3.35 TB/s.  The 2·nnz·k = 14.5 GFLOP take 0.22 ms at 67 TFLOP/s, so both
// kernels are bound by bytes.  What they really move is larger: every
// nonzero gathers one B row (200 B), 29.0 GB in all, because the rows of B
// it needs are scattered over 3.36 GB, far beyond the 50 MB L2.
//
// The Pallas kernels hold the whole output (or one output tile) in VMEM and
// walk the triplets in a sequential grid.  On Hopper blocks run in no order:
//
//  * spmm (unsorted): the output is zeroed first; each warp takes runs of 32
//    triplets, loaded coalesced and broadcast by shuffle; for each triplet
//    the lanes cover the k columns, gather B[col, :] and add into out[row, :]
//    with atomicAdd (red.global.add.f32).  The atomics add in an order that
//    changes from run to run, so the fp32 result is reproducible only to
//    rounding: hold it to a tolerance, never bitwise.
//  * spmm_sorted: one warp owns one 8-row output tile of the sort_rows packed
//    layout.  It walks the tile's units in packed order, and only their
//    `valid` slots, adds into an 8 × 128 accumulator in shared memory, and
//    writes the tile once.  The grid covers every tile, also those without
//    units, so rows that own no triplets come out 0 with no masking pass.
//    No atomics: repeated runs are bit-identical.
//
// Triplets whose row or column falls outside the output or B are skipped
// (the reference's scatter drops out-of-range updates too).  All offsets
// into B and the output are 64-bit: row · k passes 2^31 at other shapes.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;                  // 8 warps per block
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 8;                  // blocksparse.ROW_TILE
constexpr int PANEL = 128;                    // output columns per block
constexpr int COLS_PER_LANE = PANEL / 32;
constexpr unsigned MAX_BLOCKS = 1u << 16;     // unsorted: grid-stride cap

template <typename T>
__global__ void __launch_bounds__(THREADS)
spmm_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
            const int* __restrict__ cols, const T* __restrict__ B,
            float* __restrict__ out, int64_t nnz, int64_t m_out, int64_t n,
            int64_t k) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * THREADS) >> 5;
  for (int64_t base = warp * 32; base < nnz; base += warps * 32) {
    const int64_t i = base + lane;
    float v = 0.f;
    int r = -1, c = -1;
    if (i < nnz) {
      v = to_f32(vals[i]);
      r = rows[i];
      c = cols[i];
    }
    const int run = nnz - base < 32 ? (int)(nnz - base) : 32;
    for (int j = 0; j < run; ++j) {
      const float vj = __shfl_sync(FULL, v, j);
      const int rj = __shfl_sync(FULL, r, j);
      const int cj = __shfl_sync(FULL, c, j);
      if (rj < 0 || rj >= m_out || cj < 0 || cj >= n) continue;  // warp-uniform
      const T* brow = B + (int64_t)cj * k;
      float* orow = out + (int64_t)rj * k;
      for (int64_t col = lane; col < k; col += 32)
        atomicAdd(orow + col, vj * to_f32(brow[col]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
spmm_sorted_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                   const int* __restrict__ cols,
                   const int* __restrict__ first_unit,
                   const int* __restrict__ valid, const T* __restrict__ B,
                   float* __restrict__ out, int64_t ntiles, int64_t m_out,
                   int64_t n, int64_t k, int64_t align) {
  __shared__ float acc[WARPS][TILE_ROWS][PANEL];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * WARPS + warp;
  if (t >= ntiles) return;  // the whole warp: no block-wide barrier follows
  const int64_t c0 = (int64_t)blockIdx.y * PANEL;
  const int64_t left = k - c0;  // columns of this panel: min(left, PANEL)
  float(*a)[PANEL] = acc[warp];
#pragma unroll
  for (int rr = 0; rr < TILE_ROWS; ++rr)
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) a[rr][lane + 32 * j] = 0.f;
  __syncwarp();

  const int64_t row0 = t * TILE_ROWS;
  const T* bpanel = B + c0;
  const int u_end = first_unit[t + 1];
  for (int64_t u = first_unit[t]; u < u_end; ++u) {
    const int nv = valid[u];
    const int64_t base = u * align;
    for (int s0 = 0; s0 < nv; s0 += 32) {
      const int s = s0 + lane;
      float v = 0.f;
      int r = -1, c = -1;
      if (s < nv) {
        v = to_f32(vals[base + s]);
        r = (int)(rows[base + s] - row0);
        c = cols[base + s];
      }
      const int run = nv - s0 < 32 ? nv - s0 : 32;
      for (int j = 0; j < run; ++j) {
        const float vj = __shfl_sync(FULL, v, j);
        const int rj = __shfl_sync(FULL, r, j);
        const int cj = __shfl_sync(FULL, c, j);
        if (rj < 0 || rj >= TILE_ROWS || row0 + rj >= m_out || cj < 0 ||
            cj >= n)
          continue;  // warp-uniform
        const T* brow = bpanel + (int64_t)cj * k;
#pragma unroll
        for (int jj = 0; jj < COLS_PER_LANE; ++jj) {
          const int col = lane + 32 * jj;
          if (col < left)
            a[rj][col] = fmaf(vj, to_f32(brow[col]), a[rj][col]);
        }
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < TILE_ROWS; ++rr) {
    const int64_t gr = row0 + rr;
    if (gr >= m_out) break;
    float* orow = out + gr * k + c0;
#pragma unroll
    for (int jj = 0; jj < COLS_PER_LANE; ++jj) {
      const int col = lane + 32 * jj;
      if (col < left) orow[col] = a[rr][col];
    }
  }
}

}  // namespace

// out (m_out, k) fp32 = A · B for nnz COO triplets and B (n, k): zeroes out,
// then scatter-adds.
extern "C" int spmm_launch(int dtype, const void* vals, const void* rows,
                           const void* cols, const void* B, void* out,
                           int64_t nnz, int64_t m_out, int64_t n, int64_t k,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != repro_torch::kF32 && dtype != repro_torch::kBF16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)(m_out * k) * sizeof(float), s);
  if (err != cudaSuccess || nnz == 0) return (int)err;
  int64_t blocks = (nnz + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  float* o = static_cast<float*>(out);
  if (dtype == repro_torch::kF32) {
    spmm_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(vals), r, c, static_cast<const float*>(B), o,
        nnz, m_out, n, k);
  } else {
    spmm_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), r, c,
        static_cast<const __nv_bfloat16*>(B), o, nnz, m_out, n, k);
  }
  return (int)cudaGetLastError();
}

// out (m_out, k) fp32 = A · B from the sort_rows packed layout.  first_unit
// has ntiles + 1 entries: tile t owns units [first_unit[t], first_unit[t+1]),
// unit u the slots [u·align, u·align + valid[u]).  Every tile is written.
extern "C" int spmm_sorted_launch(int dtype, const void* vals,
                                  const void* rows, const void* cols,
                                  const void* first_unit, const void* valid,
                                  const void* B, void* out, int64_t ntiles,
                                  int64_t m_out, int64_t n, int64_t k,
                                  int64_t align, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t blocks = (ntiles + WARPS - 1) / WARPS;
  const int64_t panels = (k + PANEL - 1) / PANEL;
  if (blocks > 0x7fffffff || panels > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)panels);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const int* f = static_cast<const int*>(first_unit);
  const int* vd = static_cast<const int*>(valid);
  float* o = static_cast<float*>(out);
  if (dtype == repro_torch::kF32) {
    spmm_sorted_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(vals), r, c, f, vd,
        static_cast<const float*>(B), o, ntiles, m_out, n, k, align);
  } else if (dtype == repro_torch::kBF16) {
    spmm_sorted_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), r, c, f, vd,
        static_cast<const __nv_bfloat16*>(B), o, ntiles, m_out, n, k, align);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
