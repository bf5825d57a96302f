// The local update computations (LUC) of MU and HALS on Hopper (sm_90a):
// the fused multiplicative update and the sequential HALS column sweep
// (H-step form), for a factor panel X (r, k), its Gram partner G (k, k)
// fp32 and the cross product R (r, k), for every k.
//
// Replaces the TPU kernels `_mu_kernel` / `mu_update` of
// src/repro/kernels/mu_update.py (pallas_call at :36) and `_hals_kernel` /
// `hals_sweep` of src/repro/kernels/hals_sweep.py (pallas_call at :53).
//
//   mu_update:  out = X ⊙ (R / (X·G + ε))
//   hals_sweep: for i = 0..k-1 in order,
//               x_i ← max(0, x_i + (R_i − X·G_i) / max(G_ii, ε))
//
// ε is an argument: the wrappers default to the TPU kernels' 1e-16, the
// update rules pass eps_for(X.dtype).  X is fp32 or bf16, R fp32 or X's
// dtype, sums in fp32, the output in X's dtype.  The sweep rounds each new
// column to X's dtype before later columns read it, as the rule's
// `X[:, i] = xi.to(X.dtype)` does (a no-op in fp32).
//
// Bound at the main paths' shapes (H100 SXM, fp32, k = 50): each kernel
// reads X and R once and writes X once, 12·r·k bytes, and does 2·r·k²
// flops.  Video's W (r = 1,013,400): 0.608 GB, 0.181 ms at 3.35 TB/s
// against 0.076 ms of flops at 67 TFLOP/s; the Webbase-density factor
// (r = 2^24): 10.07 GB, 3.00 ms against 1.25 ms.  Both are bound by bytes,
// and the flops reach the bound only if they overlap the copies.
//
// mu_update_kernel (any k that its plan fits; ops.plan_mu_update):
//  * Persistent blocks (one or two per SM) walk tiles of `rows` rows in a
//    grid-stride loop.  G, read coalesced, is staged in shared memory once
//    per block as k rows of kcp columns (the chunk rounded up to 4, zeros
//    past k): (X·G)_j for four adjacent j is one float4 broadcast per l.
//    A k too wide for the whole of G beside the ring takes G in column
//    chunks, restaged per tile.
//  * The X and R panels of the next tiles arrive by cp.async (16-byte
//    words when both panels' addresses allow, else 4-byte) into a ring of
//    `stages` stages, so they overlap this tile's product and epilogue.
//  * X's panel is widened to fp32 with an odd row stride (ks = k | 1), or,
//    `direct`, an fp32 X is read in the stage itself, where its stride k
//    puts the 16 rows a warp reads in distinct banks (gcd(k, 32) ≤ 2).  A
//    thread task is RT rows × 4 adjacent columns (RT = rows / 16), its
//    rows 16 apart in the panel: at one l a warp reads 16 different rows
//    (distinct banks: the stride is odd) and two float4s of G (two column
//    groups, each a broadcast), 16·RT FMAs for RT + 1 shared loads.  A
//    64-row tile at k = 50 is 208 tasks, one round of the block's 256
//    threads.  Nothing is padded to a power of two: the column loop runs
//    to k rounded up to 4.
//  * Each (X·G)_j is one fp32 chain over l = 0..k-1 in order, and the
//    epilogue keeps the reference's x_j · (r_j / ((X·G)_j + ε)).  A task
//    owns its outputs, so it writes them over its own R entries in the
//    stage; the block then stores the stage to `out` coalesced, once.
//  * No atomics, a fixed order: repeated runs are bit-identical.
// mu_rowwise_kernel: the k no plan fits (G and one 8-row tile beyond
//  shared memory, k ≳ 2,000): one warp per row, lane j over columns j,
//  j + 32, …, G read through L1/L2.  For correctness, not speed.
//
// hals_sweep_kernel (k ≤ 128): one thread owns one row for the whole
// sweep, its row of X in KMAX registers (KMAX ∈ {16, 32, 64, 128}), Gᵀ
// and the X and R panels of 128 rows in shared memory.
// hals_rowwise_kernel (k > 128): one warp owns one row.  The row lives in
// `out` (X's dtype, so each new column is rounded there before later
// columns read it), lane l holding columns l, l + 32, …; column i's X·G_i
// is lane FMAs against row i of Gᵀ (transposed once per call into scratch
// by luc_transpose_kernel, so the lanes' reads coalesce; L1 holds it up to
// k ≈ 200, L2 beyond) and a fixed butterfly, and lane i mod 32 writes x_i.
// For correctness, not speed.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROWS = 128;        // hals_sweep_kernel: rows per block
constexpr int KMAX_LIMIT = 128;  // hals_sweep_kernel: the widest template
constexpr int MU_THREADS = 256;  // mu_update_kernel: 8 warps
constexpr int WIDE_THREADS = 256;  // rowwise kernels: 8 warps, a row each

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// mu_update_kernel
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int64_t align16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// Byte offsets of mu_update_kernel's shared memory: G (or a chunk of its
// columns), X's fp32 panel (none when `direct`), then `stages` stages of
// (X panel, R panel) as they arrive (a copy's lead-in of up to 16 bytes
// included).  ops.py's mu_smem computes the same sizes.
struct MuLayout {
  int64_t g, xf, xpanel, rpanel, stage, total;
};

__host__ __device__ __forceinline__ MuLayout mu_layout(int64_t k, int rows,
                                                       int stages, int chunk,
                                                       int sx, int sr,
                                                       bool direct) {
  MuLayout L;
  const int64_t kcp = (chunk + 3) / 4 * 4;
  L.g = align16(k * kcp * 4);
  L.xf = direct ? 0 : align16((int64_t)rows * (k | 1) * 4);
  L.xpanel = align16((int64_t)rows * k * sx + 16);
  L.rpanel = align16((int64_t)rows * k * sr + 16);
  L.stage = L.xpanel + L.rpanel;
  L.total = L.g + L.xf + stages * L.stage;
  return L;
}

// cp.async of `bytes` contiguous bytes at src into dst in W-byte words,
// shared by the block's threads (common.cuh's word helpers).
template <int W>
__device__ __forceinline__ void issue_panel(unsigned char* dst,
                                            const void* src, int64_t bytes,
                                            const void* fallback) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const int64_t words = repro_torch::words_for<W>(s, bytes);
  for (int64_t j = threadIdx.x; j < words; j += blockDim.x)
    repro_torch::copy_word<W>(reinterpret_cast<char*>(dst), s, bytes, j,
                              fallback);
}

template <typename TX, typename TR, int RT>
__global__ void __launch_bounds__(MU_THREADS, 2)
mu_update_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                 const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                 int k, int rows, int stages, int chunk, int vec, int direct,
                 float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool dx = direct && sizeof(TX) == 4;  // x read from the fp32 stage
  const MuLayout L = mu_layout(k, rows, stages, chunk, sizeof(TX),
                               sizeof(TR), dx);
  float* gs = reinterpret_cast<float*>(smem);
  float* xf = reinterpret_cast<float*>(smem + L.g);
  unsigned char* ring = smem + L.g + L.xf;
  const int tid = threadIdx.x;
  const int ks = k | 1;
  const int kcp = (chunk + 3) / 4 * 4;
  const int nrs = rows / RT;                   // row slices of a tile
  const int W = vec ? 16 : 4;
  const int64_t ntiles = (r + rows - 1) / rows;
  // the (row, column) of this thread's first element of a panel, and the
  // step to its next (MU_THREADS elements on)
  const int t0 = tid / k, l0 = tid % k;
  const int dr = MU_THREADS / k, dc = MU_THREADS % k;

  // G[:, c0 : c0 + chunk) as k rows of kcp columns, zeros past k
  auto stage_g = [&](int c0) {
    const int cw = min(chunk, k - c0);
    for (int e = tid; e < k * kcp; e += MU_THREADS) {
      const int l = e / kcp, j = e - l * kcp;
      gs[e] = j < cw ? G[(int64_t)l * k + c0 + j] : 0.f;
    }
  };
  // the X and R panels of `tile` into stage s, as one commit group (an
  // empty one past the last tile, so the group count stays in step)
  auto issue = [&](int64_t tile, int s) {
    if (tile < ntiles) {
      const int64_t row0 = tile * rows;
      const int64_t nr = r - row0 < rows ? r - row0 : rows;
      unsigned char* st = ring + s * L.stage;
      if (vec) {
        issue_panel<16>(st, X + row0 * k, nr * k * sizeof(TX), X);
        issue_panel<16>(st + L.xpanel, R + row0 * k, nr * k * sizeof(TR), R);
      } else {
        issue_panel<4>(st, X + row0 * k, nr * k * sizeof(TX), X);
        issue_panel<4>(st + L.xpanel, R + row0 * k, nr * k * sizeof(TR), R);
      }
    }
    repro_torch::cp_async_commit();
  };

  if (chunk >= k) stage_g(0);          // visible after the first barrier
  int64_t tile = blockIdx.x;
  for (int s = 0; s + 1 < stages; ++s) issue(tile + (int64_t)s * gridDim.x, s);
  for (int64_t it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int s = (int)(it % stages);
    issue(tile + (int64_t)(stages - 1) * gridDim.x,
          (int)((it + stages - 1) % stages));
    if (stages >= 3)
      repro_torch::cp_async_wait<2>();
    else if (stages == 2)
      repro_torch::cp_async_wait<1>();
    else
      repro_torch::cp_async_wait<0>();
    __syncthreads();                   // this tile's panels have landed

    const int64_t row0 = tile * rows;
    const int nr = (int)(r - row0 < rows ? r - row0 : rows);
    unsigned char* st = ring + s * L.stage;
    const TX* xp = reinterpret_cast<const TX*>(
        st + (reinterpret_cast<uintptr_t>(X + row0 * k) & (W - 1)));
    TR* rp = reinterpret_cast<TR*>(
        st + L.xpanel + (reinterpret_cast<uintptr_t>(R + row0 * k) & (W - 1)));
    if (!dx) {
      for (int e = tid, t = t0, l = l0; e < nr * k; e += MU_THREADS) {
        xf[t * ks + l] = to_f32(xp[e]);
        t += dr;
        l += dc;
        if (l >= k) { l -= k; ++t; }
      }
      __syncthreads();
    }
    const float* xs = dx ? reinterpret_cast<const float*>(xp) : xf;
    const int xst = dx ? k : ks;       // the row stride of xs

    for (int c0 = 0; c0 < k; c0 += chunk) {
      if (chunk < k) {                 // G in column chunks
        if (c0 > 0) __syncthreads();
        stage_g(c0);
        __syncthreads();
      }
      const int cw = min(chunk, k - c0);
      const int tasks = nrs * ((cw + 3) / 4);
      for (int q = tid; q < tasks; q += MU_THREADS) {
        const int rs = q % nrs, cg = q / nrs;
        const float* xrow = xs + rs * xst;     // rows rs + i·nrs
        const float4* gcol = reinterpret_cast<const float4*>(gs) + cg;
        float acc[RT][4];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 4
        for (int l = 0; l < k; ++l) {
          const float4 g = gcol[l * (kcp / 4)];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float x = xrow[i * nrs * xst + l];
            acc[i][0] = fmaf(x, g.x, acc[i][0]);
            acc[i][1] = fmaf(x, g.y, acc[i][1]);
            acc[i][2] = fmaf(x, g.z, acc[i][2]);
            acc[i][3] = fmaf(x, g.w, acc[i][3]);
          }
        }
        // out_j = x_j · (r_j / ((X·G)_j + ε)), over this task's R entries
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const int t = rs + i * nrs;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jj = cg * 4 + c;
            if (t < nr && jj < cw) {
              const int j = c0 + jj;
              TR* p = rp + t * k + j;
              store(p, xs[t * xst + j] * (to_f32(*p) / (acc[i][c] + eps)));
            }
          }
        }
      }
    }
    __syncthreads();
    TX* o = out + row0 * k;
    for (int e = tid; e < nr * k; e += MU_THREADS) store(o + e, to_f32(rp[e]));
    __syncthreads();                   // the stage and xf are free again
  }
  repro_torch::cp_async_wait<0>();
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(WIDE_THREADS)
mu_rowwise_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                  const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                  int64_t k, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (WIDE_THREADS / 32);
  for (int64_t t = (int64_t)blockIdx.x * (WIDE_THREADS / 32) +
                   (threadIdx.x >> 5);
       t < r; t += warps) {
    const TX* x = X + t * k;
    for (int64_t j0 = 0; j0 < k; j0 += 32) {
      const int64_t j = j0 + lane;
      const bool live = j < k;
      float acc = 0.f;
      for (int64_t l = 0; l < k; ++l) {
        const float g = live ? G[l * k + j] : 0.f;
        acc = fmaf(to_f32(x[l]), g, acc);
      }
      if (live)
        store(out + t * k + j,
              to_f32(x[j]) * (to_f32(R[t * k + j]) / (acc + eps)));
    }
  }
}

// ---------------------------------------------------------------------------
// hals_sweep_kernel (k ≤ 128)
// ---------------------------------------------------------------------------

// Shared memory of one block: Gᵀ (k × KMAX), then the X and R panels
// (ROWS × ks each, ks = k rounded up to odd).
template <int KMAX>
__host__ __device__ constexpr int64_t smem_floats(int k, int ks) {
  return (int64_t)k * KMAX + 2 * (int64_t)ROWS * ks;
}

// Copy a contiguous panel of n elements (rows of k) between device memory
// and a shared panel of row stride ks, converting to/from fp32.  Thread t
// takes elements t, t + ROWS, ...; its (row, col) advance incrementally, and
// LOAD_BATCH loads go out before their stores so that enough bytes are
// in flight.
constexpr int LOAD_BATCH = 16;

template <typename T>
__device__ __forceinline__ void load_panel(const T* __restrict__ src, int n,
                                           int k, int ks, float* dst) {
  int row = threadIdx.x / k, col = threadIdx.x % k;
  const int dr = ROWS / k, dc = ROWS % k;
  for (int e0 = threadIdx.x; e0 < n; e0 += LOAD_BATCH * ROWS) {
    float v[LOAD_BATCH];
    int at[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int e = e0 + u * ROWS;
      v[u] = e < n ? to_f32(src[e]) : 0.f;
      at[u] = row * ks + col;
      row += dr;
      col += dc;
      if (col >= k) { col -= k; ++row; }
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u)
      if (e0 + u * ROWS < n) dst[at[u]] = v[u];
  }
}

template <typename T>
__device__ __forceinline__ void store_panel(T* __restrict__ dst, int n, int k,
                                            int ks, const float* src) {
  int row = threadIdx.x / k, col = threadIdx.x % k;
  const int dr = ROWS / k, dc = ROWS % k;
  for (int e = threadIdx.x; e < n; e += ROWS) {
    store(dst + e, src[row * ks + col]);
    row += dr;
    col += dc;
    if (col >= k) { col -= k; ++row; }
  }
}

// Σ_l x[l] · gcol[l] over KMAX (gcol zero beyond k), in four partial sums.
template <int KMAX>
__device__ __forceinline__ float dot_row(const float (&x)[KMAX],
                                         const float* gcol) {
  const float4* g4 = reinterpret_cast<const float4*>(gcol);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int q = 0; q < KMAX / 4; ++q) {
    const float4 g = g4[q];
    a0 = fmaf(x[4 * q], g.x, a0);
    a1 = fmaf(x[4 * q + 1], g.y, a1);
    a2 = fmaf(x[4 * q + 2], g.z, a2);
    a3 = fmaf(x[4 * q + 3], g.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

template <typename TX, typename TR, int KMAX>
__global__ void __launch_bounds__(ROWS)
hals_sweep_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                  const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                  int k, int ks, float eps) {
  extern __shared__ __align__(16) float hsmem[];
  float* gt = hsmem;
  float* xp = gt + (int64_t)k * KMAX;
  float* rp = xp + (int64_t)ROWS * ks;
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)(r - row0 < ROWS ? r - row0 : ROWS);
  for (int e = t; e < k * KMAX; e += ROWS) {
    const int i = e / KMAX;          // column of G
    const int l = e % KMAX;
    gt[e] = l < k ? G[(int64_t)l * k + i] : 0.f;
  }
  load_panel(X + row0 * k, rows * k, k, ks, xp);
  load_panel(R + row0 * k, rows * k, k, ks, rp);
  __syncthreads();
  float x[KMAX];
  if (t < rows) {
#pragma unroll
    for (int l = 0; l < KMAX; ++l) x[l] = l < k ? xp[t * ks + l] : 0.f;
    for (int i = 0; i < k; ++i) {
      const float xg = dot_row<KMAX>(x, gt + i * KMAX);
      float gii = gt[i * KMAX + i];
      gii = gii < eps ? eps : gii;
      float v = xp[t * ks + i] + (rp[t * ks + i] - xg) / gii;
      v = v < 0.f ? 0.f : v;                  // max(v, 0), keeping a NaN
      v = round_to(v, static_cast<TX*>(nullptr));
      xp[t * ks + i] = v;
#pragma unroll
      for (int l = 0; l < KMAX; ++l) x[l] = l == i ? v : x[l];
    }
  }
  __syncthreads();
  store_panel(out + row0 * k, rows * k, k, ks, xp);
}

// ---------------------------------------------------------------------------
// hals_rowwise_kernel (k > 128)
// ---------------------------------------------------------------------------

// Gt = Gᵀ for G (k, k), through 32 × 32 tiles in shared memory so that
// both the reads and the writes coalesce.
__global__ void __launch_bounds__(256)
luc_transpose_kernel(const float* __restrict__ G, float* __restrict__ Gt,
                     int64_t k) {
  __shared__ float tile[32][33];
  const int64_t c0 = (int64_t)blockIdx.x * 32, r0 = (int64_t)blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int y = ty; y < 32; y += 8)
    if (r0 + y < k && c0 + tx < k) tile[y][tx] = G[(r0 + y) * k + c0 + tx];
  __syncthreads();
  for (int y = ty; y < 32; y += 8)
    if (c0 + y < k && r0 + tx < k) Gt[(c0 + y) * k + r0 + tx] = tile[tx][y];
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(WIDE_THREADS)
hals_rowwise_kernel(const TX* __restrict__ X, const float* __restrict__ Gt,
                    const TR* __restrict__ R, TX* out, int64_t r, int64_t k,
                    float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (WIDE_THREADS / 32);
  for (int64_t t = (int64_t)blockIdx.x * (WIDE_THREADS / 32) +
                   (threadIdx.x >> 5);
       t < r; t += warps) {
    // lane l owns columns l, l + 32, ...: it alone reads and writes them
    TX* o = out + t * k;
    for (int64_t l = lane; l < k; l += 32) o[l] = X[t * k + l];
    for (int64_t i = 0; i < k; ++i) {
      const float* gi = Gt + i * k;            // column i of G
      float s = 0.f;
      for (int64_t l = lane; l < k; l += 32) s = fmaf(to_f32(o[l]), gi[l], s);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)    // the same sum in every lane
        s += __shfl_xor_sync(FULL, s, off);
      if (lane == (int)(i & 31)) {
        float gii = gi[i];
        gii = gii < eps ? eps : gii;
        float v = to_f32(o[i]) + (to_f32(R[t * k + i]) - s) / gii;
        v = v < 0.f ? 0.f : v;                 // max(v, 0), keeping a NaN
        store(o + i, v);                       // rounded to X's dtype
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename TX, typename TR, int RT>
cudaError_t launch_mu_ring(const void* X, const void* G, const void* R,
                           void* out, int64_t r, int k, float eps, int rows,
                           int stages, int chunk, int blocks, int vec,
                           int direct, cudaStream_t s) {
  const MuLayout L = mu_layout(k, rows, stages, chunk, sizeof(TX),
                               sizeof(TR), direct && sizeof(TX) == 4);
  if (L.total > 232448) return cudaErrorInvalidValue;
  auto kern = &mu_update_kernel<TX, TR, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kern<<<blocks, MU_THREADS, L.total, s>>>(
      static_cast<const TX*>(X), static_cast<const float*>(G),
      static_cast<const TR*>(R), static_cast<TX*>(out), r, k, rows, stages,
      chunk, vec, direct, eps);
  return cudaGetLastError();
}

template <typename TX, typename TR>
cudaError_t launch_mu(const void* X, const void* G, const void* R, void* out,
                      int64_t r, int64_t k, float eps, int rows, int stages,
                      int chunk, int rt, int blocks, int vec, int direct,
                      cudaStream_t s) {
  if (rows == 0) {
    mu_rowwise_kernel<TX, TR><<<blocks, WIDE_THREADS, 0, s>>>(
        static_cast<const TX*>(X), static_cast<const float*>(G),
        static_cast<const TR*>(R), static_cast<TX*>(out), r, k, eps);
    return cudaGetLastError();
  }
  if (stages < 1 || stages > 3 || chunk < 1 || rows % rt || rows > 1024)
    return cudaErrorInvalidValue;
  const int kk = (int)k;
  if (rt == 8)
    return launch_mu_ring<TX, TR, 8>(X, G, R, out, r, kk, eps, rows, stages,
                                     chunk, blocks, vec, direct, s);
  if (rt == 4)
    return launch_mu_ring<TX, TR, 4>(X, G, R, out, r, kk, eps, rows, stages,
                                     chunk, blocks, vec, direct, s);
  if (rt == 2)
    return launch_mu_ring<TX, TR, 2>(X, G, R, out, r, kk, eps, rows, stages,
                                     chunk, blocks, vec, direct, s);
  if (rt == 1)
    return launch_mu_ring<TX, TR, 1>(X, G, R, out, r, kk, eps, rows, stages,
                                     chunk, blocks, vec, direct, s);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TR, int KMAX>
cudaError_t launch_hals_typed(const void* X, const void* G, const void* R,
                              void* out, int64_t r, int k, float eps,
                              cudaStream_t s) {
  const int ks = k | 1;
  const size_t bytes = (size_t)smem_floats<KMAX>(k, ks) * sizeof(float);
  auto kern = &hals_sweep_kernel<TX, TR, KMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((r + ROWS - 1) / ROWS);
  kern<<<blocks, ROWS, bytes, s>>>(
      static_cast<const TX*>(X), static_cast<const float*>(G),
      static_cast<const TR*>(R), static_cast<TX*>(out), r, k, ks, eps);
  return cudaGetLastError();
}

template <typename TX, typename TR>
cudaError_t launch_hals(const void* X, const void* G, const void* R,
                        void* out, void* scratch, int64_t r, int64_t k,
                        float eps, int blocks, cudaStream_t s) {
  const int kk = (int)k;
  if (k <= 16)
    return launch_hals_typed<TX, TR, 16>(X, G, R, out, r, kk, eps, s);
  if (k <= 32)
    return launch_hals_typed<TX, TR, 32>(X, G, R, out, r, kk, eps, s);
  if (k <= 64)
    return launch_hals_typed<TX, TR, 64>(X, G, R, out, r, kk, eps, s);
  if (k <= KMAX_LIMIT)
    return launch_hals_typed<TX, TR, 128>(X, G, R, out, r, kk, eps, s);
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int64_t tiles = (k + 31) / 32;
  if (tiles > 65535) return cudaErrorInvalidValue;
  float* Gt = static_cast<float*>(scratch);
  luc_transpose_kernel<<<dim3((unsigned)tiles, (unsigned)tiles), 256, 0, s>>>(
      static_cast<const float*>(G), Gt, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  hals_rowwise_kernel<TX, TR><<<blocks, WIDE_THREADS, 0, s>>>(
      static_cast<const TX*>(X), Gt, static_cast<const TR*>(R),
      static_cast<TX*>(out), r, k, eps);
  return cudaGetLastError();
}

template <typename TX, typename TR>
cudaError_t launch_op(int op, const void* X, const void* G, const void* R,
                      void* out, void* scratch, int64_t r, int64_t k,
                      float eps, int rows, int stages, int chunk, int rt,
                      int blocks, int vec, int direct, cudaStream_t s) {
  if (op == 0)
    return launch_mu<TX, TR>(X, G, R, out, r, k, eps, rows, stages, chunk, rt,
                             blocks, vec, direct, s);
  return launch_hals<TX, TR>(X, G, R, out, scratch, r, k, eps, blocks, s);
}

}  // namespace

// The widest k of hals_sweep's register-resident kernel (ops.LUC_HALS_KMAX);
// wider k takes hals_rowwise_kernel, which needs a k × k fp32 scratch.
extern "C" int luc_tiles(int* out) {
  out[0] = KMAX_LIMIT;
  return 0;
}

// op 0: mu_update on the plan (rows, stages, chunk, rt, blocks, vec,
// direct) of ops.plan_mu_update; rows = 0 takes the row-per-warp kernel
// on `blocks` blocks.  op 1: hals_sweep; for k > KMAX_LIMIT, `scratch`
// holds k × k fp32 and `blocks` sizes the row-per-warp grid.  X and out (r, k) of
// x_dtype, R (r, k) of r_dtype (fp32, or X's dtype), G (k, k) fp32, all
// contiguous; out may not alias X or R.  Dtype codes: 0 fp32, 1 bf16.
extern "C" int luc_launch(int op, int x_dtype, int r_dtype, const void* X,
                          const void* G, const void* R, void* out,
                          void* scratch, int64_t r, int64_t k, float eps,
                          int rows, int stages, int chunk, int rt, int blocks,
                          int vec, int direct, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((op != 0 && op != 1) || k < 1 || k > 0x7fffffff || r < 1 ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro_torch::kF32 && r_dtype == repro_torch::kF32)
    return (int)launch_op<float, float>(op, X, G, R, out, scratch, r, k, eps,
                                        rows, stages, chunk, rt, blocks, vec,
                                        direct, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kF32)
    return (int)launch_op<bf16, float>(op, X, G, R, out, scratch, r, k, eps,
                                       rows, stages, chunk, rt, blocks, vec,
                                       direct, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kBF16)
    return (int)launch_op<bf16, bf16>(op, X, G, R, out, scratch, r, k, eps,
                                      rows, stages, chunk, rt, blocks, vec,
                                      direct, s);
  return (int)cudaErrorInvalidValue;
}
