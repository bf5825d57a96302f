// Sparse × dense products of the sparse path on Hopper (sm_90a): out (m, k)
// fp32 = A · B for A as COO triplets (vals, rows, cols) and a dense B (n, k),
// B and vals in fp32 or bf16, sums in fp32.  Aᵀ·B is the same call with rows
// and cols swapped (unsorted) or on the column-sorted copy (sorted).
//
// Replaces the TPU kernels of src/repro/kernels/spmm.py:
//  * spmm (spmm_scatter_kernel, with spmm_count/scan/bucket_kernel for the
//    L2-blocked scatter) <- `_spmm_kernel` / `spmm` (pallas_call at :99);
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
//  * spmm (unsorted) adds into a zeroed output with fp32 reductions, in one
//    pass or, when the output is far beyond the 50 MB L2 and its rows come
//    in no order, in four (ops.plan_spmm decides):
//     - spmm_scatter_kernel: each warp walks a contiguous run of triplets,
//       32 at a time, loaded coalesced and broadcast by shuffle.  The lanes
//       cover a 64-column panel of the row (blockIdx.y): two adjacent
//       columns each when k is even and B's rows are 8-byte aligned (a
//       vector gather and one red.global.add.v2.f32 per lane), else
//       columns lane and lane + 32 with scalar reductions.  Run
//       aggregation: the lanes keep the partial row in registers while
//       consecutive triplets share their output row, and reduce it into
//       the output once per change of row.  blockify's row-major triplets
//       (A·B) arrive in runs of ≈ 8.6 per row at Webbase's density, so
//       A·B makes one reduction per row instead of one per triplet.  The
//       B rows of 8 triplets are loaded before any is added, so that many
//       gathers are in flight per warp.
//     - The L2-blocked scatter for scattered targets (Aᵀ·C, whose targets
//       are A's columns in row-major order: uniformly random rows of a
//       3.36 GB output).  spmm_count_kernel counts each warp's triplets per
//       bucket of 2^shift output rows (a bucket's slice of the output is
//       at most ≈ 16 MB); spmm_scan_kernel turns the counts, bucket-major
//       and then by warp, into offsets; spmm_bucket_kernel copies each
//       triplet to its place in scratch, stably (a warp's triplets in
//       order, ranked among equal buckets with __match_any_sync).  Then
//       spmm_scatter_kernel runs over the bucketed scratch with short runs
//       per warp in a grid of many blocks: the blocks in flight at any
//       time work within one or two buckets, so the reductions land in
//       output rows that L2 holds instead of read-modify-writes of HBM.
//    Out-of-range triplets are dropped by the counting pass (rows) or
//    skipped by the scatter (columns).  The reductions add in an order
//    that changes from run to run, so the fp32 result is reproducible only
//    to rounding: hold it to a tolerance, never bitwise.
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
constexpr int PANEL = 128;                    // spmm_sorted: output columns per block
constexpr int COLS_PER_LANE = PANEL / 32;
constexpr int SPANEL = 64;                    // spmm: output columns per block
constexpr int GATHER = 8;                     // B rows loaded ahead per warp
constexpr int MAX_BUCKETS = 512;              // ops.SPMM_MAX_BUCKETS
constexpr int LOADS = 4;                      // counting: runs loaded ahead
constexpr int ILOADS = 8;                     // bucketing: runs per warp and tile
constexpr int TILE = THREADS * ILOADS;        // bucketing: triplets per tile

// out[a], out[a + 1] += x, y in one vector reduction (sm_90, PTX ISA 8.1);
// a must be 8-byte aligned.
__device__ __forceinline__ void red_v2(float* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x),
               "f"(y)
               : "memory");
}

// Two columns of B's row: (col, col + 1) with VEC = 2, (col, col + 32)
// otherwise; columns past k read as 0.
template <int VEC>
__device__ __forceinline__ float2 load_pair(const float* row, int64_t col,
                                            int64_t k) {
  if (VEC == 2)
    return col < k ? *reinterpret_cast<const float2*>(row + col)
                   : make_float2(0.f, 0.f);
  return make_float2(col < k ? row[col] : 0.f,
                     col + 32 < k ? row[col + 32] : 0.f);
}
template <int VEC>
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row,
                                            int64_t col, int64_t k) {
  if (VEC == 2)
    return col < k ? __bfloat1622float2(
                         *reinterpret_cast<const __nv_bfloat162*>(row + col))
                   : make_float2(0.f, 0.f);
  return make_float2(col < k ? to_f32(row[col]) : 0.f,
                     col + 32 < k ? to_f32(row[col + 32]) : 0.f);
}

template <int VEC>
__device__ __forceinline__ void flush(float* orow, int64_t col, int64_t k,
                                      float2 acc) {
  if (VEC == 2) {
    if (col < k) red_v2(orow + col, acc.x, acc.y);
  } else {
    if (col < k) atomicAdd(orow + col, acc.x);
    if (col + 32 < k) atomicAdd(orow + col + 32, acc.y);
  }
}

// out += A · B for the triplets [w·per_warp, (w+1)·per_warp) of each warp w
// (of the first *count triplets when count is given, else of nnz), panel
// blockIdx.y of 64 output columns.  VEC = 2 needs k even and B's rows
// 8-byte (fp32) or 4-byte (bf16) aligned.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
spmm_scatter_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                    const int* __restrict__ cols, const T* __restrict__ B,
                    float* __restrict__ out, int64_t nnz,
                    const int* __restrict__ count, int64_t m_out, int64_t n,
                    int64_t k, int64_t per_warp) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int64_t total = count ? (int64_t)*count : nnz;
  const int64_t begin = warp * per_warp;
  const int64_t end = begin + per_warp < total ? begin + per_warp : total;
  const int64_t col = (int64_t)blockIdx.y * SPANEL + (VEC == 2 ? 2 * lane : lane);
  float2 acc = make_float2(0.f, 0.f);
  int cur = -1;                                 // the row acc belongs to
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t i = base + lane;
    float v = 0.f;
    int r = -1, c = 0;
    if (i < end) {
      v = to_f32(vals[i]);
      r = rows[i];
      c = cols[i];
      if (r >= m_out || c < 0 || c >= n) r = -1;   // skipped
    }
    const int run = end - base < 32 ? (int)(end - base) : 32;
    for (int j0 = 0; j0 < run; j0 += GATHER) {
      float vj[GATHER];
      int rj[GATHER];
      float2 bj[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int src = j0 + u < run ? j0 + u : 0;
        vj[u] = __shfl_sync(FULL, v, src);
        rj[u] = j0 + u < run ? __shfl_sync(FULL, r, src) : -1;
        const int cj = __shfl_sync(FULL, c, src);
        bj[u] = rj[u] >= 0 ? load_pair<VEC>(B + (int64_t)cj * k, col, k)
                           : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        if (rj[u] < 0) continue;                   // warp-uniform
        if (rj[u] != cur) {
          if (cur >= 0) flush<VEC>(out + (int64_t)cur * k, col, k, acc);
          cur = rj[u];
          acc = make_float2(0.f, 0.f);
        }
        acc.x = fmaf(vj[u], bj[u].x, acc.x);
        acc.y = fmaf(vj[u], bj[u].y, acc.y);
      }
    }
  }
  if (cur >= 0) flush<VEC>(out + (int64_t)cur * k, col, k, acc);
}

// The bucket of each in-range triplet: row >> shift, else -1.
__device__ __forceinline__ int bucket_of(int r, int64_t m_out, int shift) {
  return r >= 0 && r < m_out ? r >> shift : -1;
}

// Exclusive prefix sum of one value per thread over a block of THREADS
// threads, in thread order; *total receives the sum of all.
__device__ __forceinline__ int block_exclusive_scan(int x, int* wsum,
                                                    int* total) {
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[wl] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < wl ? wsum[w] : 0;
    all += wsum[w];
  }
  __syncthreads();                 // wsum is free again
  *total = all;
  return before + incl - x;
}

// Pass 1 of the L2-blocked scatter: counts[b · gridDim.x + blk] = the
// triplets of block blk's chunk [blk·chunk, (blk+1)·chunk) whose row lies
// in bucket b.
__global__ void __launch_bounds__(THREADS)
spmm_count_kernel(const int* __restrict__ rows, int64_t nnz, int64_t m_out,
                  int shift, int nb, int64_t chunk, int* __restrict__ counts) {
  __shared__ int hist[MAX_BUCKETS];
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < nb; b += THREADS) hist[b] = 0;
  __syncthreads();
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < nnz ? begin + chunk : nnz;
  const int64_t first = begin + (threadIdx.x & ~31) * LOADS;
  for (int64_t base = first; base < end; base += (int64_t)THREADS * LOADS) {
    int r[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int64_t i = base + 32 * u + lane;
      r[u] = i < end ? rows[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int b = bucket_of(r[u], m_out, shift);
      if (b >= 0) atomicAdd(hist + b, 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += THREADS)
    counts[(int64_t)b * gridDim.x + blockIdx.x] = hist[b];
}

// Exclusive prefix sum of counts[0, len) in place, one block; counts[len]
// receives the total.
__global__ void __launch_bounds__(1024)
spmm_scan_kernel(int* __restrict__ counts, int64_t len) {
  __shared__ int wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, wl = tid >> 5;
  const int64_t seg = (len + blockDim.x - 1) / blockDim.x;
  const int64_t lo = tid * seg < len ? tid * seg : len;
  const int64_t hi = lo + seg < len ? lo + seg : len;
  int sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += counts[i];
  int incl = sum;                                   // warp-inclusive scan
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[wl] = incl;
  __syncthreads();
  if (wl == 0) {
    int x = lane < (int)(blockDim.x / 32) ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    wsum[lane] = x;                                 // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (wl > 0 ? wsum[wl - 1] : 0);
  for (int64_t i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (tid == (int)blockDim.x - 1) counts[len] = run;
}

// Pass 2: each in-range triplet of block blk's chunk to its slot in the
// bucketed scratch, stably, from the offsets of spmm_scan_kernel.  The chunk
// goes by tiles of TILE triplets: each is ranked by (bucket, position) in
// shared memory — per warp with __match_any_sync, then across warps and
// buckets by prefix sums — and staged there in that order, so that the
// copy to scratch writes each bucket's part of the tile as one contiguous
// run (coalesced), not as scattered 4-byte stores.
template <typename T>
__global__ void __launch_bounds__(THREADS)
spmm_bucket_kernel(const T* __restrict__ vals, const int* __restrict__ rows,
                   const int* __restrict__ cols, int64_t nnz, int64_t m_out,
                   int shift, int nb, int64_t chunk,
                   const int* __restrict__ offsets, T* __restrict__ s_vals,
                   int* __restrict__ s_rows, int* __restrict__ s_cols) {
  __shared__ int wcnt[WARPS * MAX_BUCKETS];   // per warp, then its offset
  __shared__ int cursor[MAX_BUCKETS];         // next scratch slot per bucket
  __shared__ int toff[MAX_BUCKETS];           // the bucket's first tile slot
  __shared__ int tcnt[MAX_BUCKETS];           // the bucket's tile count
  __shared__ int st_rows[TILE], st_cols[TILE];
  __shared__ T st_vals[TILE];
  __shared__ int wsum[WARPS];
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  constexpr int PER = (MAX_BUCKETS + THREADS - 1) / THREADS;
  for (int b = threadIdx.x; b < nb; b += THREADS)
    cursor[b] = offsets[(int64_t)b * gridDim.x + blockIdx.x];
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < nnz ? begin + chunk : nnz;
  for (int64_t tile = begin; tile < end; tile += TILE) {
    for (int idx = threadIdx.x; idx < WARPS * nb; idx += THREADS)
      wcnt[idx] = 0;
    __syncthreads();
    // the warp's 32·ILOADS triplets, in runs of 32, ranked within the warp
    int r[ILOADS], c[ILOADS], b[ILOADS], rank[ILOADS];
    T v[ILOADS];
    const int64_t wbase = tile + (int64_t)wl * 32 * ILOADS;
#pragma unroll
    for (int u = 0; u < ILOADS; ++u) {
      const int64_t i = wbase + 32 * u + lane;
      r[u] = -1;
      if (i < end) {
        r[u] = rows[i];
        c[u] = cols[i];
        v[u] = vals[i];
      }
      b[u] = bucket_of(r[u], m_out, shift);
    }
    int* wc = wcnt + wl * nb;
#pragma unroll
    for (int u = 0; u < ILOADS; ++u) {
      const unsigned peers = __match_any_sync(FULL, b[u]);
      const int before = b[u] >= 0 ? wc[b[u]] : 0;
      rank[u] = before + __popc(peers & below);
      __syncwarp();
      if (b[u] >= 0 && (peers & below) == 0) wc[b[u]] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per bucket: the warps' counts become offsets among the bucket's part
    // of the tile; then the buckets' parts are laid out in bucket order
    int mine[PER], sum = 0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int bb = threadIdx.x * PER + p;
      int run = 0;
      if (bb < nb) {
        for (int w = 0; w < WARPS; ++w) {
          const int x = wcnt[w * nb + bb];
          wcnt[w * nb + bb] = run;
          run += x;
        }
      }
      mine[p] = run;
      sum += run;
    }
    int total;
    int off = block_exclusive_scan(sum, wsum, &total);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int bb = threadIdx.x * PER + p;
      if (bb < nb) {
        toff[bb] = off;
        tcnt[bb] = mine[p];
      }
      off += mine[p];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < ILOADS; ++u) {
      if (b[u] < 0) continue;
      const int slot = toff[b[u]] + wc[b[u]] + rank[u];
      st_rows[slot] = r[u];
      st_cols[slot] = c[u];
      st_vals[slot] = v[u];
    }
    __syncthreads();
    for (int slot = threadIdx.x; slot < total; slot += THREADS) {
      const int rr = st_rows[slot];
      const int bb = rr >> shift;
      const int64_t pos = (int64_t)cursor[bb] + slot - toff[bb];
      s_rows[pos] = rr;
      s_cols[pos] = st_cols[slot];
      s_vals[pos] = st_vals[slot];
    }
    __syncthreads();
    for (int bb = threadIdx.x; bb < nb; bb += THREADS) cursor[bb] += tcnt[bb];
  }
}

template <typename T, int VEC>
cudaError_t launch_scatter(const void* vals, const int* rows, const int* cols,
                           const void* B, float* out, int64_t nnz,
                           const int* count, int64_t m_out, int64_t n,
                           int64_t k, int64_t per_warp, cudaStream_t s) {
  const int64_t blocks = (nnz + per_warp * WARPS - 1) / (per_warp * WARPS);
  const int64_t panels = (k + SPANEL - 1) / SPANEL;
  if (blocks > 0x7fffffff || panels > 65535) return cudaErrorInvalidValue;
  spmm_scatter_kernel<T, VEC><<<dim3((unsigned)blocks, (unsigned)panels),
                                THREADS, 0, s>>>(
      static_cast<const T*>(vals), rows, cols, static_cast<const T*>(B), out,
      nnz, count, m_out, n, k, per_warp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scatter(bool vec, const void* vals, const int* rows,
                           const int* cols, const void* B, float* out,
                           int64_t nnz, const int* count, int64_t m_out,
                           int64_t n, int64_t k, int64_t per_warp,
                           cudaStream_t s) {
  return vec ? launch_scatter<T, 2>(vals, rows, cols, B, out, nnz, count,
                                    m_out, n, k, per_warp, s)
             : launch_scatter<T, 1>(vals, rows, cols, B, out, nnz, count,
                                    m_out, n, k, per_warp, s);
}

// The three passes of the L2-blocked scatter's bucketing (count, scan,
// copy) into s_vals/s_rows/s_cols, offsets in counts (nb·blocks + 1 ints,
// the last the number of bucketed triplets).
template <typename T>
cudaError_t launch_buckets(const void* vals, const int* rows, const int* cols,
                           int64_t nnz, int64_t m_out, int shift, int nb,
                           int64_t blocks, void* s_vals, int* s_rows,
                           int* s_cols, int* counts, cudaStream_t s) {
  // scratch offsets are int32
  if (nb > MAX_BUCKETS || blocks > 0x7fffffff || nnz >= 0x7fffffff)
    return cudaErrorInvalidValue;
  int64_t chunk = (nnz + blocks - 1) / blocks;
  chunk = (chunk + TILE - 1) / TILE * TILE;
  spmm_count_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      rows, nnz, m_out, shift, nb, chunk, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spmm_scan_kernel<<<1, 1024, 0, s>>>(counts, nb * blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  spmm_bucket_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(vals), rows, cols, nnz, m_out, shift, nb, chunk,
      counts, static_cast<T*>(s_vals), s_rows, s_cols);
  return cudaGetLastError();
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

// out (m_out, k) fp32 = A · B for nnz COO triplets and B (n, k): zeroes
// out, then adds.  vec: k even and B's rows 8-byte (fp32) / 4-byte (bf16)
// aligned, for the vector gathers and reductions.  nb ≤ 1: one pass,
// per_warp triplets per warp.  nb > 1: the L2-blocked scatter into nb
// buckets of 2^shift rows, `blocks` blocks in its counting and copying
// passes, scratch s_vals/s_rows/s_cols of nnz triplets and counts of
// nb·blocks + 1 ints, then per_warp triplets per warp of the scratch.
extern "C" int spmm_launch(int dtype, const void* vals, const void* rows,
                           const void* cols, const void* B, void* out,
                           int64_t nnz, int64_t m_out, int64_t n, int64_t k,
                           int vec, int shift, int nb, int64_t blocks,
                           int64_t per_warp, void* s_vals, void* s_rows,
                           void* s_cols, void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != repro_torch::kF32 && dtype != repro_torch::kBF16)
    return (int)cudaErrorInvalidValue;
  if (per_warp <= 0 || per_warp % 32) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)(m_out * k) * sizeof(float), s);
  if (err != cudaSuccess || nnz == 0) return (int)err;
  const bool f32 = dtype == repro_torch::kF32;
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  float* o = static_cast<float*>(out);
  const int* count = nullptr;
  if (nb > 1) {
    int* cnt = static_cast<int*>(counts);
    int* sr = static_cast<int*>(s_rows);
    int* sc = static_cast<int*>(s_cols);
    err = f32 ? launch_buckets<float>(vals, r, c, nnz, m_out, shift, nb,
                                      blocks, s_vals, sr, sc, cnt, s)
              : launch_buckets<__nv_bfloat16>(vals, r, c, nnz, m_out, shift,
                                              nb, blocks, s_vals, sr, sc, cnt,
                                              s);
    if (err != cudaSuccess) return (int)err;
    vals = s_vals;
    r = sr;
    c = sc;
    count = cnt + (int64_t)nb * blocks;
  }
  err = f32 ? launch_scatter<float>(vec != 0, vals, r, c, B, o, nnz, count,
                                    m_out, n, k, per_warp, s)
            : launch_scatter<__nv_bfloat16>(vec != 0, vals, r, c, B, o, nnz,
                                            count, m_out, n, k, per_warp, s);
  return (int)err;
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
