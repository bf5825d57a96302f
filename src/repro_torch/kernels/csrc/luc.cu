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
// hals_sweep_kernel (any k that its plan fits; ops.plan_hals_sweep):
//  * The sweep in column blocks of HB = 16.  For column c of block J, the
//    sum Σ_l x_l·G_lc (columns before c new) is taken in three parts: the
//    columns outside the block as the row stands (before J new, after J
//    old), the block's old columns from c on, and, as the block's columns
//    are swept in order, each new x_j·G_jc.  In exact arithmetic that is
//    the sequential sweep, and no old value is added and taken back (an
//    old-then-correct form cancelled, 1e-6 of the sweep's scale at k = 50,
//    10× the plain version; this order lands as close to float64 sums as
//    the plain version does).  The product over the columns outside the
//    block leaves the serial chain (W independent fp32 chains, each over l
//    in order), a block's values sit in fixed registers, and nothing is
//    padded past k rounded up to 4 (the last block is 4, 8, 12 or 16 wide;
//    G is zero past k).  1 / max(G_jj, ε) is taken once per block of
//    threads, so the chain per column is a subtract and an FMA.
//  * TPR threads own a row of the tile for the whole sweep (TPR = 1, or 4
//    where G and a row of X and R leave few rows an SM: thread q then sums
//    the block's columns 4q..4q+3 and the sums reach the row's other
//    threads by shuffles), so the blocks of a tile need no barrier: G[:,
//    J] (k × HB floats) is read from shared memory as float4s (broadcasts
//    when TPR = 1), x_l one shared load per row.  G is staged once per
//    block of threads when all of it fits beside the ring (`gblocks` = the
//    number of column blocks), else restaged from L2 per block of columns
//    (`gblocks` = 1; two barriers per column block).
//  * The X and R panels of the next tiles arrive by cp.async into a ring of
//    `stages` stages (mu_update_kernel's copies), persistent blocks walking
//    the tiles in a grid-stride loop.  An fp32 X with gcd(k, 32) ≤ 2 is
//    swept where it lands (`direct`: 32 rows at stride k fall in 16 or 32
//    banks); otherwise X is widened to fp32 at the odd stride k | 1.  New
//    values are rounded to X's dtype as they are written, overwrite the
//    panel and are stored coalesced, once.
//  * max(v, 0) keeps a NaN, as the plain version; no atomics and a fixed
//    order, so repeated runs and every plan give the same bits.
// Bound: bytes (12·r·k fp32) at k = 50; at k = 160 the fp32 operations of
// the sweep, 2·r·k², are 0.774 ms at Video's rows against 0.58 ms of bytes.
// Measured (tools/probe_luc_spmm.py, PERF.md §6): at k = 50 it is neither
// issue- nor shared-load-bound; the rows resident on an SM (two blocks of
// 256 rows, one stage each) set how much of the copies the sweep hides.
// hals_rowwise_kernel: the k no plan fits (one 32-row tile, one stage and
// a column block of G beyond shared memory: k ≥ 516 fp32, not every k
// above; ops.plan_hals_sweep decides).  One warp owns one row.  The row
// lives in `out` (X's dtype, so each new column is rounded there before
// later columns read it), lane l holding columns l, l + 32, …; column
// i's X·G_i is lane FMAs against row i of Gᵀ (transposed once per call
// into scratch by luc_transpose_kernel, so the lanes' reads coalesce) and
// a fixed butterfly, and lane i mod 32 writes x_i.  For correctness, not
// speed.
//
// hals_sweep_norm (the W-step of the HALS rules on one device; replaces
// no TPU kernel: the reference leaves its W-step to XLA, and the plain
// version is a Python loop of about ten launches a column):
//   for i = 0..k-1 in order,
//     x_i ← max(0, x_i·G_ii + R_i − X·G_i);  x_i ← x_i / max(‖x_i‖, ε)
//   where ‖x_i‖ > 0, ‖x_i‖ the fp32 norm of the clamped column over ALL r
//   rows, each new x_i rounded to X's dtype before later columns read it.
//  * Column i's norm must be complete before column i + 1 starts, so no
//    row panel can sweep on its own: the barrier is a kernel boundary, k +
//    1 launches on the stream from one host call.  Each pass writes its
//    blocks' sums of squares of the column it finishes (a fixed order, no
//    atomics); the next pass's blocks each reduce them in a fixed order
//    (the same bits in every block) and divide by max(‖x‖, ε) as they next
//    read the column.  Repeated runs on a plan are bit-identical.
//  * Columns go in blocks of NB = 8, like hals_sweep_kernel's.  A block's
//    head pass reads each row once (from X, copying it to out, for the
//    first block; from out after), normalises and writes the previous
//    block's columns, and takes for each column c of the block its sum
//    over every column but the block's newer ones: q_c = x_c·G_cc + r_c −
//    Σ x_l·G_lc (l before the block new, after it old, and the block's own
//    old l ≥ c).  Column j0 is then finished.  q goes to Q, a column-major
//    (NB, r) fp32 scratch panel (coalesced, 0.54 GB at r = 2^24).  A head
//    pass stages its tile (by cp.async for fp32, every copy in flight at
//    once), the tile's R[:, J] and previous block in shared memory, and
//    writes the previous block to out NB adjacent lanes a row.  Each
//    other column c of the block is a column pass that reads only Q: the
//    newer columns' v, normalised, times G, taken from q_c, then clamped.
//    The tail pass normalises the last block into out.
//  * Bound: bytes.  At r = 2^24, k = 50 fp32: 7 head passes of ≈ 360 bytes
//    a row (the row, R's 8 columns and the previous block's in sectors, Q
//    written and read) and 43 column passes of 4·(s + 2) bytes a row, ≈ 61
//    GB, 18 ms at 3.35 TB/s, against 221 GB (66 ms) for one pass over the
//    rows per column and 3.0 ms for the half-update's bytes read once.
//    Measured (tools/probe_hals_norm.py, PERF.md §6): 29.6 ms, of which
//    the head passes 21.4: R's block and out's are scattered sectors, one
//    or two a row, which hold those passes near 2 TB/s.
//  * Every k: where no tile of rows fits a block's shared memory (k >
//    1,438), the head pass is norm_head_wide_kernel, the same sums in the
//    same order a thread a row through the caches.  For correctness, not
//    speed.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MU_THREADS = 256;  // mu_update_kernel: 8 warps
constexpr int HB = 16;           // hals_sweep_kernel: columns per block
// hals_sweep_kernel: at most 256 threads a block, and registers for two
// such blocks on an SM (≤ 128 a thread), as ops.plan_hals_sweep plans
// (HALS_MAX_THREADS, HALS_THREADS_PER_SM)
constexpr int HALS_MAX_THREADS = 256;
constexpr int HALS_MIN_BLOCKS = 2;
constexpr int WIDE_THREADS = 256;  // rowwise kernels: 8 warps, a row each
// hals_sweep_norm: columns per block (the column-major scratch panel's
// width), the threads of its column and tail passes, and the most threads
// (a row each) of its head pass
constexpr int NB = 8;
constexpr int NORM_THREADS = 256;
constexpr int NORM_MAX_THREADS = 128;
constexpr int NORM_MAX_WARPS = NORM_MAX_THREADS / 32;
// blocks an SM holds (registers for): head passes of 128 threads, column
// and tail passes of NORM_THREADS (ops.HALS_NORM_HEAD_PER_SM, _COLUMN_PER_SM)
constexpr int NORM_HEAD_BLOCKS = 8;
constexpr int NORM_COLUMN_BLOCKS = 4;

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
// hals_sweep_kernel
// ---------------------------------------------------------------------------

// Byte offsets of hals_sweep_kernel's shared memory: `gblocks` column
// blocks of G (k rows of HB floats each), the k reciprocals 1 / max(G_jj,
// ε), X's fp32 panel (none when `direct`), then `stages` stages of (X
// panel, R panel) as they arrive.  ops.py's hals_smem computes the same
// sizes.
struct HalsLayout {
  int64_t g, rdiag, xf, xpanel, rpanel, stage, total;
};

__host__ __device__ __forceinline__ HalsLayout hals_layout(
    int64_t k, int rows, int stages, int gblocks, int sx, int sr,
    bool direct) {
  HalsLayout L;
  L.g = align16((int64_t)gblocks * k * HB * 4);
  L.rdiag = align16(k * 4);
  L.xf = direct ? 0 : align16((int64_t)rows * (k | 1) * 4);
  L.xpanel = align16((int64_t)rows * k * sx + 16);
  L.rpanel = align16((int64_t)rows * k * sr + 16);
  L.stage = L.xpanel + L.rpanel;
  L.total = L.g + L.rdiag + L.xf + stages * L.stage;
  return L;
}

// One block of W columns from j0 (W a multiple of 4 · TPR, j0 + W ≤ k
// rounded up to 4) of the sweep of one row, shared by its TPR threads:
// thread q of the row (q < TPR) owns the block's columns cb = q·W/TPR to
// cb + W/TPR.  x is the row (fp32, k values), r its row of R, gb = G[:,
// j0 : j0 + HB) as k rows of HB floats (zeros past k), rd the reciprocals
// 1 / max(G_jj, ε).  For each column c of the block, s_c = Σ_l x_l ·
// G_{l, j0+c} with the columns before j0+c new, summed by c's owner:
//   the columns l outside the block, as they stand (before j0 new, after
//   the block old), one fp32 chain over l in order;
//   then the block's own columns l ≥ j0+c, old, added in order;
//   then, for c in order, x_{j0+c} ← max(0, x + (r − s_c) · rd_j), rounded
//   to X's dtype (every thread of the row computes it, from s_c shuffled
//   from its owner), and the new value times G_{j0+c, c'} added to every
//   later s_c' of the block.
// That is the sequential sweep's sum with its terms in another order: no
// old value is added and then taken back, and every TPR adds each s_c in
// the same order (the same bits).  The block's new values are stored after
// its serial chain, so that chain is only the arithmetic.
template <typename TX, typename TR, int TPR, int W>
__device__ __forceinline__ void hals_block(float* x, const TR* r,
                                           const float* gb, const float* rd,
                                           int k, int j0, int q) {
  constexpr int CW = W / TPR;          // columns a thread owns
  static_assert(CW % 4 == 0, "a thread owns whole float4s of G");
  const int cb = q * CW;
  float p[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) p[c] = 0.f;
  const float4* g4 = reinterpret_cast<const float4*>(gb) + cb / 4;
  const int jw = j0 + W < k ? j0 + W : k;      // the block's end
  for (int part = 0; part < 2; ++part) {       // l < j0, then l ≥ jw
    const int l1 = part ? k : j0;
#pragma unroll 2
    for (int l = part ? jw : 0; l < l1; ++l) {
      float4 g[CW / 4];
#pragma unroll
      for (int i = 0; i < CW / 4; ++i) g[i] = g4[l * (HB / 4) + i];
      const float xl = x[l];
#pragma unroll
      for (int i = 0; i < CW / 4; ++i) {
        p[4 * i] = fmaf(xl, g[i].x, p[4 * i]);
        p[4 * i + 1] = fmaf(xl, g[i].y, p[4 * i + 1]);
        p[4 * i + 2] = fmaf(xl, g[i].z, p[4 * i + 2]);
        p[4 * i + 3] = fmaf(xl, g[i].w, p[4 * i + 3]);
      }
    }
  }
  // the block's old columns: x_{j0+e} · G_{j0+e, c} for c ≤ e
#pragma unroll
  for (int e = 0; e < W; ++e) {
    if (j0 + e < k) {                  // the same for every thread
      const float xe = x[j0 + e];
#pragma unroll
      for (int i = 0; i < CW / 4; ++i) {
        if (TPR > 1 || 4 * i <= e) {
          const float4 g = g4[(j0 + e) * (HB / 4) + i];
          const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (cb + 4 * i + u <= e)
              p[4 * i + u] = fmaf(xe, gv[u], p[4 * i + u]);
        }
      }
    }
  }
  float xn[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (j0 + c < k) {
      float s = p[c % CW];
      if (TPR > 1)                     // from the thread that owns c
        s = __shfl_sync(FULL, s, (threadIdx.x & 31 & ~(TPR - 1)) | (c / CW),
                        32);
      float v = fmaf(to_f32(r[j0 + c]) - s, rd[j0 + c], x[j0 + c]);
      v = v < 0.f ? 0.f : v;           // max(v, 0), keeping a NaN
      v = round_to(v, static_cast<TX*>(nullptr));
      xn[c] = v;
      // row j0 + c of the block's G, at this thread's columns after c
#pragma unroll
      for (int i = 0; i < CW / 4; ++i) {
        if (TPR > 1 || 4 * i + 3 > c) {
          const float4 g = g4[(j0 + c) * (HB / 4) + i];
          const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (cb + 4 * i + u > c)
              p[4 * i + u] = fmaf(v, gv[u], p[4 * i + u]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c)
    if (j0 + c < k) x[j0 + c] = xn[c];
}

template <typename TX, typename TR, int TPR>
__global__ void __launch_bounds__(HALS_MAX_THREADS, HALS_MIN_BLOCKS)
hals_sweep_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                  const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                  int k, int stages, int gblocks, int vec, int direct,
                  float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int rows = nt / TPR;                   // TPR threads a row
  const bool dx = direct && sizeof(TX) == 4;  // x swept in the fp32 stage
  const HalsLayout L = hals_layout(k, rows, stages, gblocks, sizeof(TX),
                                   sizeof(TR), dx);
  float* gs = reinterpret_cast<float*>(smem);
  float* rd = reinterpret_cast<float*>(smem + L.g);
  float* xf = reinterpret_cast<float*>(smem + L.g + L.rdiag);
  unsigned char* ring = smem + L.g + L.rdiag + L.xf;
  const int tid = threadIdx.x;
  const int ks = k | 1;
  const int nb = (k + HB - 1) / HB;            // column blocks
  const bool whole = gblocks >= nb;            // all of G, staged once
  const int W = vec ? 16 : 4;
  const int64_t ntiles = (r + rows - 1) / rows;
  // the (row, column) of this thread's first element of a panel, and the
  // step to its next (nt elements on)
  const int t0 = tid / k, l0 = tid % k;
  const int dr = nt / k, dc = nt % k;

  // G[:, b·HB : (b + 1)·HB) as k rows of HB floats, zeros past k
  auto stage_g = [&](int b, float* dst) {
    const int c0 = b * HB;
    for (int e = tid; e < k * HB; e += nt) {
      const int l = e / HB, c = e % HB;
      dst[e] = c0 + c < k ? G[(int64_t)l * k + c0 + c] : 0.f;
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

  // visible after the first barrier
  for (int j = tid; j < k; j += nt) {
    const float gjj = G[(int64_t)j * k + j];
    rd[j] = 1.f / (gjj < eps ? eps : gjj);
  }
  if (whole)
    for (int b = 0; b < nb; ++b) stage_g(b, gs + (int64_t)b * k * HB);
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
    TX* xp = reinterpret_cast<TX*>(
        st + (reinterpret_cast<uintptr_t>(X + row0 * k) & (W - 1)));
    const TR* rp = reinterpret_cast<const TR*>(
        st + L.xpanel + (reinterpret_cast<uintptr_t>(R + row0 * k) & (W - 1)));
    if (!dx) {
      for (int e = tid, t = t0, l = l0; e < nr * k; e += nt) {
        xf[t * ks + l] = to_f32(xp[e]);
        t += dr;
        l += dc;
        if (l >= k) { l -= k; ++t; }
      }
      __syncthreads();
    }
    // Rows past nr hold a stale stage: they are swept and never stored.
    float* xs = dx ? reinterpret_cast<float*>(xp) : xf;
    float* xrow = xs + (tid / TPR) * (dx ? k : ks);
    const TR* rrow = rp + (tid / TPR) * k;
    const int q = tid % TPR;

    for (int b = 0; b < nb; ++b) {
      const float* gb = gs + (whole ? (int64_t)b * k * HB : 0);
      if (!whole) {                    // G restaged per block of columns
        if (b > 0) __syncthreads();
        stage_g(b, gs);
        __syncthreads();
      }
      const int j0 = b * HB, w = k - j0;      // the last block narrower
      if constexpr (TPR == 4) {
        hals_block<TX, TR, 4, 16>(xrow, rrow, gb, rd, k, j0, q);
      } else {
        if (w > 12)
          hals_block<TX, TR, 1, 16>(xrow, rrow, gb, rd, k, j0, q);
        else if (w > 8)
          hals_block<TX, TR, 1, 12>(xrow, rrow, gb, rd, k, j0, q);
        else if (w > 4)
          hals_block<TX, TR, 1, 8>(xrow, rrow, gb, rd, k, j0, q);
        else
          hals_block<TX, TR, 1, 4>(xrow, rrow, gb, rd, k, j0, q);
      }
    }
    __syncthreads();
    TX* o = out + row0 * k;
    if (dx) {
      for (int e = tid; e < nr * k; e += nt) store(o + e, xs[e]);
    } else {
      for (int e = tid, t = t0, l = l0; e < nr * k; e += nt) {
        store(o + e, xf[t * ks + l]);
        t += dr;
        l += dc;
        if (l >= k) { l -= k; ++t; }
      }
    }
    __syncthreads();                   // the stage, xf and G are free again
  }
  repro_torch::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// hals_rowwise_kernel (the k no plan of hals_sweep_kernel fits)
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
// hals_sweep_norm: the W-step's normalised sweep
// ---------------------------------------------------------------------------

// Byte offsets of norm_head_kernel's shared memory: G[:, j0 : j0 + NB) as k
// rows of NB floats, the NB divisors of the previous block, the warps'
// partial sums, the tile's R[:, J] (a row of NB at the odd stride NB + 1)
// and previous block's Q (NB columns of `rows`), then the tile's rows in
// fp32 at the odd stride k | 1.  ops.py's hals_norm_smem computes the same
// sizes.
struct NormLayout {
  int64_t g, ds, red, rs, qs, xf, total;
};

__host__ __device__ __forceinline__ NormLayout norm_layout(int64_t k,
                                                           int rows) {
  NormLayout L;
  L.g = align16(k * NB * 4);
  L.ds = align16(NB * 4);
  L.red = align16(NORM_MAX_WARPS * 4);
  L.rs = align16((int64_t)rows * (NB + 1) * 4);
  L.qs = align16((int64_t)NB * rows * 4);
  L.xf = align16((int64_t)rows * (k | 1) * 4);
  L.total = L.g + L.ds + L.red + L.rs + L.qs + L.xf;
  return L;
}

// The sum of `v` over the block's threads, in a fixed order (a butterfly
// in each warp, then the warps in order), in thread 0.  `red` holds one
// float a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(FULL, v, off);
  const int warp = threadIdx.x / 32, warps = (blockDim.x + 31) / 32;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

// The divisor of column c, max(‖x_c‖, ε) where ‖x_c‖ > 0 and 1 otherwise
// (x / 1 = x: the rule's `where(nrm > 0, x / max(nrm, ε), x)`, a NaN norm
// included), from its `count` per-block sums of squares at `part`, summed
// by one warp in a fixed order (lane l adds blocks l, l + 32, …, then a
// butterfly): every block computes the same bits.  Call with a whole warp.
__device__ __forceinline__ float column_divisor(const float* part, int count,
                                                float eps) {
  float acc = 0.f;
#pragma unroll 8
  for (int b = threadIdx.x & 31; b < count; b += 32) acc += part[b];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(FULL, acc, off);
  const float nrm = sqrtf(acc);
  return nrm > 0.f ? (nrm < eps ? eps : nrm) : 1.f;
}

// How many per-block sums of squares column c has: the head pass of its
// block (c a multiple of NB) writes `ph`, a column pass `pc`.
__device__ __forceinline__ int column_parts(int c, int ph, int pc) {
  return c % NB == 0 ? ph : pc;
}

// The divisors of the previous block's `pw` columns (ending at j0) into
// ds: the last from its sums of squares, computed here by warp 0 (block 0
// also writes it to dsc for later passes), the others from dsc, where the
// passes that reduced them left them.  Visible after the next barrier.
__device__ __forceinline__ void previous_divisors(const float* part,
                                                  float* dsc, float* ds,
                                                  int j0, int pw, int ph,
                                                  int pc, int pm, float eps) {
  if (pw == 0) return;
  if (threadIdx.x < 32) {
    const int c = j0 - 1;
    const float d = column_divisor(part + (int64_t)c * pm,
                                   column_parts(c, ph, pc), eps);
    if (threadIdx.x == 0) {
      ds[pw - 1] = d;
      if (blockIdx.x == 0) dsc[c] = d;
    }
  }
  for (int u = threadIdx.x; u < pw - 1; u += blockDim.x)
    ds[u] = dsc[j0 - pw + u];
}

// The head pass of the block of columns J = [j0, j0 + w), w = min(NB, k −
// j0), a thread a row over tiles of `rows` rows (persistent blocks, a
// grid-stride loop).  For each row:
//  * its tile is read once, from X for the first block (and copied to out,
//    so that out holds every column's current value), else from out;
//  * the previous block's pw values v (from Q, column-major) are
//    normalised, x = v / d rounded to X's dtype, and written to out and to
//    the row;
//  * for each c of J, a_c = Σ x_l·G_lc over the columns l outside J (before
//    J new, after J old), one fp32 chain over l in order, then J's own old
//    columns l ≥ c in order; q_c = (x_c·G_cc + r_c) − a_c, the rule's form
//    (its x_c·G_cc added here and inside a_c);
//  * column j0, which has no newer column of J before it, is finished:
//    v = max(q, 0) (keeping a NaN) goes to Q[0] and v² to the thread's
//    sum; the other q_c go to Q[c − j0], for the column passes.
// The block's sum of squares of column j0 goes to part[j0·pm + block].
template <typename TX, typename TR>
__global__ void __launch_bounds__(NORM_MAX_THREADS, NORM_HEAD_BLOCKS)
norm_head_kernel(const TX* src, const TR* __restrict__ R,
                 const float* __restrict__ G, TX* out, float* __restrict__ Q,
                 float* __restrict__ part, float* __restrict__ dsc, int64_t r,
                 int k, int j0, int pw, int ph, int pc, int pm, float eps,
                 int first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = blockDim.x;
  const NormLayout L = norm_layout(k, rows);
  float* gb = reinterpret_cast<float*>(smem);
  float* ds = reinterpret_cast<float*>(smem + L.g);
  float* red = reinterpret_cast<float*>(smem + L.g + L.ds);
  float* rs = reinterpret_cast<float*>(smem + L.g + L.ds + L.red);
  float* qs = reinterpret_cast<float*>(smem + L.g + L.ds + L.red + L.rs);
  float* xf = reinterpret_cast<float*>(smem + L.g + L.ds + L.red + L.rs +
                                       L.qs);
  const int tid = threadIdx.x;
  const int ks = k | 1;
  const int w = k - j0 < NB ? k - j0 : NB;
  const int jw = j0 + w;
  const int64_t ntiles = (r + rows - 1) / rows;
  // the (row, column) of this thread's first element of a tile, and the
  // step to its next (rows elements on)
  const int t0 = tid / k, l0 = tid % k;
  const int dr = rows / k, dc = rows % k;

  previous_divisors(part, dsc, ds, j0, pw, ph, pc, pm, eps);
  for (int e = tid; e < k * NB; e += rows) {
    const int l = e / NB, c = e % NB;
    gb[e] = c < w ? G[(int64_t)l * k + j0 + c] : 0.f;
  }
  __syncthreads();

  float ss = 0.f;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows;
    const int nr = (int)(r - row0 < rows ? r - row0 : rows);
    const int n = nr * k;
    const TX* sp = src + row0 * k;
    TX* op = out + row0 * k;
    // The tile's rows into xf: fp32 element by element by cp.async, all
    // of the tile's copies in flight at once; bf16 through registers.
    if constexpr (sizeof(TX) == 4) {
      for (int e = tid, t = t0, l = l0; e < n; e += rows) {
        repro_torch::cp_async4(xf + t * ks + l, sp + e, 4);
        t += dr;
        l += dc;
        if (l >= k) { l -= k; ++t; }
      }
    } else {
      constexpr int U = 8;                     // loads in flight a thread
      for (int e0 = 0, t = t0, l = l0; e0 < n; e0 += U * rows) {
        TX v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * rows + tid;
          v[u] = sp[e < n ? e : 0];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * rows + tid;
          if (e < n) {
            xf[t * ks + l] = to_f32(v[u]);
            if (first) op[e] = v[u];
          }
          t += dr;
          l += dc;
          if (l >= k) { l -= k; ++t; }
        }
      }
    }
    // R[:, J] and the previous block's Q: NB adjacent lanes a row of R,
    // consecutive lanes consecutive rows of a column of Q
    for (int e = tid; e < nr * NB; e += rows) {
      const int i = e / NB, c = e % NB;
      if (c < w) {
        const TR* src_r = R + (row0 + i) * k + j0 + c;
        if constexpr (sizeof(TR) == 4)
          repro_torch::cp_async4(rs + i * (NB + 1) + c, src_r, 4);
        else
          rs[i * (NB + 1) + c] = to_f32(*src_r);
      }
    }
    for (int e = tid; e < pw * rows; e += rows) {
      const int c = e / rows, i = e % rows;
      if (i < nr)
        repro_torch::cp_async4(qs + c * rows + i, Q + c * r + row0 + i, 4);
    }
    repro_torch::cp_async_commit();
    repro_torch::cp_async_wait<0>();
    __syncthreads();                           // the tile is in shared memory

    if (tid < nr) {
      const int64_t row = row0 + tid;
      float* x = xf + tid * ks;
      for (int c = 0; c < pw; ++c)             // the previous block, new
        x[j0 - pw + c] = round_to(qs[c * rows + tid] / ds[c],
                                  static_cast<TX*>(nullptr));
      float a[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) a[c] = 0.f;
      const float4* g4 = reinterpret_cast<const float4*>(gb);
      for (int half = 0; half < 2; ++half) {   // l < j0, then l ≥ j0 + w
        const int l1 = half ? k : j0;
#pragma unroll 2
        for (int l = half ? jw : 0; l < l1; ++l) {
          const float xl = x[l];
          const float4 ga = g4[l * (NB / 4)], gc = g4[l * (NB / 4) + 1];
          a[0] = fmaf(xl, ga.x, a[0]);
          a[1] = fmaf(xl, ga.y, a[1]);
          a[2] = fmaf(xl, ga.z, a[2]);
          a[3] = fmaf(xl, ga.w, a[3]);
          a[4] = fmaf(xl, gc.x, a[4]);
          a[5] = fmaf(xl, gc.y, a[5]);
          a[6] = fmaf(xl, gc.z, a[6]);
          a[7] = fmaf(xl, gc.w, a[7]);
        }
      }
      // J's old columns l = j0 + e ≥ c, in order
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        if (e < w) {
          const float xe = x[j0 + e];
#pragma unroll
          for (int c = 0; c <= e; ++c)
            a[c] = fmaf(xe, gb[(j0 + e) * NB + c], a[c]);
        }
      }
      const float* rrow = rs + tid * (NB + 1);
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        if (c < w) {
          const float q = fmaf(x[j0 + c], gb[(j0 + c) * NB + c], rrow[c]) -
                          a[c];
          if (c == 0) {
            const float v = q < 0.f ? 0.f : q;   // max(q, 0), keeping a NaN
            ss = fmaf(v, v, ss);
            Q[row] = v;
          } else {
            Q[c * r + row] = q;
          }
        }
      }
    }
    __syncthreads();                           // xf holds the new block
    // out: the previous block's new values, pw adjacent lanes a row; or,
    // for the first block, the copy of X (bf16: made as it was read)
    if constexpr (sizeof(TX) == 4) {
      if (first)
        for (int e = tid, t = t0, l = l0; e < n; e += rows) {
          op[e] = xf[t * ks + l];
          t += dr;
          l += dc;
          if (l >= k) { l -= k; ++t; }
        }
    }
    for (int e = tid; e < nr * pw; e += rows) {
      const int i = e / pw, c = e % pw;
      store(op + (int64_t)i * k + j0 - pw + c, xf[i * ks + j0 - pw + c]);
    }
    __syncthreads();                           // shared memory is free again
  }
  const float tot = block_sum(ss, red);
  if (tid == 0) part[(int64_t)j0 * pm + blockIdx.x] = tot;
}

// The head pass for a k whose tile of rows no block's shared memory holds
// (ops.hals_norm_rows(k) = 0): norm_head_kernel's sums, in its order, a
// thread a row (grid-stride) on blocks of NORM_THREADS, reading the row,
// G and R through the caches.  The previous block's new values are
// written to out first (rounded to X's dtype, as norm_head_kernel rounds
// them) and the row is then read back from out.  A warp's loads touch 32
// rows: for correctness, not speed.
template <typename TX, typename TR>
__global__ void __launch_bounds__(NORM_THREADS, NORM_COLUMN_BLOCKS)
norm_head_wide_kernel(const TX* src, const TR* __restrict__ R,
                      const float* __restrict__ G, TX* out,
                      float* __restrict__ Q, float* __restrict__ part,
                      float* __restrict__ dsc, int64_t r, int k, int j0,
                      int pw, int ph, int pc, int pm, float eps, int first) {
  __shared__ float ds[NB], red[NORM_THREADS / 32];
  previous_divisors(part, dsc, ds, j0, pw, ph, pc, pm, eps);
  __syncthreads();
  const int w = k - j0 < NB ? k - j0 : NB;
  const int jw = j0 + w;
  const float* gj = G + j0;                    // G[l, j0 + c] at l·k + c
  float ss = 0.f;
  const int64_t step = (int64_t)gridDim.x * NORM_THREADS;
  for (int64_t row = (int64_t)blockIdx.x * NORM_THREADS + threadIdx.x;
       row < r; row += step) {
    TX* x = out + row * k;
    if (first)
      for (int l = 0; l < k; ++l) x[l] = src[row * k + l];
    for (int c = 0; c < pw; ++c)               // the previous block, new
      store(x + j0 - pw + c, Q[c * r + row] / ds[c]);
    float a[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) a[c] = 0.f;
    for (int half = 0; half < 2; ++half) {     // l < j0, then l ≥ j0 + w
      const int l1 = half ? k : j0;
      for (int l = half ? jw : 0; l < l1; ++l) {
        const float xl = to_f32(x[l]);
        const float* gl = gj + (int64_t)l * k;
#pragma unroll
        for (int c = 0; c < NB; ++c)
          if (c < w) a[c] = fmaf(xl, gl[c], a[c]);
      }
    }
    // J's old columns l = j0 + e ≥ c, in order
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      if (e < w) {
        const float xe = to_f32(x[j0 + e]);
        const float* ge = gj + (int64_t)(j0 + e) * k;
#pragma unroll
        for (int c = 0; c <= e; ++c) a[c] = fmaf(xe, ge[c], a[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (c < w) {
        const float q = fmaf(to_f32(x[j0 + c]),
                             gj[(int64_t)(j0 + c) * k + c],
                             to_f32(R[row * k + j0 + c])) - a[c];
        if (c == 0) {
          const float v = q < 0.f ? 0.f : q;   // max(q, 0), keeping a NaN
          ss = fmaf(v, v, ss);
          Q[row] = v;
        } else {
          Q[c * r + row] = q;
        }
      }
    }
  }
  const float tot = block_sum(ss, red);
  if (threadIdx.x == 0) part[(int64_t)j0 * pm + blockIdx.x] = tot;
}

// The column pass of column c = j0 + s (0 < s < w) of the block from j0, a
// thread a row (grid-stride): the block's newer columns j0 … c − 1 are
// normalised from Q (x = v / d rounded to X's dtype) and Σ x·G_{j0+u, c}
// taken in order; v = max(q_c − Σ, 0) (keeping a NaN) replaces q_c in Q
// and v² goes to the thread's sum; the block's sum of squares goes to
// part[c·pm + block].  Column c − 1's divisor is reduced here from its
// sums of squares, the earlier ones read from dsc.
template <typename TX>
__global__ void __launch_bounds__(NORM_THREADS, NORM_COLUMN_BLOCKS)
norm_column_kernel(float* __restrict__ Q, const float* __restrict__ G,
                   float* __restrict__ part, float* __restrict__ dsc,
                   int64_t r, int k, int j0, int s, int ph, int pc, int pm,
                   float eps) {
  __shared__ float ds[NB], gc[NB], red[NORM_THREADS / 32];
  const int c = j0 + s;
  previous_divisors(part, dsc, ds, c, s, ph, pc, pm, eps);
  if (threadIdx.x < s) gc[threadIdx.x] = G[(int64_t)(j0 + threadIdx.x) * k + c];
  __syncthreads();
  float ss = 0.f;
  // two rows an iteration, `step` apart, their loads issued together
  const int64_t step = (int64_t)gridDim.x * NORM_THREADS;
  for (int64_t t = (int64_t)blockIdx.x * NORM_THREADS + threadIdx.x; t < r;
       t += 2 * step) {
    const bool two = t + step < r;
    const int64_t t2 = two ? t + step : t;
    float q[2][NB - 1];
#pragma unroll
    for (int u = 0; u < NB - 1; ++u) {
      if (u < s) {
        q[0][u] = Q[u * r + t];
        q[1][u] = Q[u * r + t2];
      }
    }
    const float qs[2] = {Q[s * r + t], Q[s * r + t2]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float n = 0.f;
#pragma unroll
      for (int u = 0; u < NB - 1; ++u) {
        if (u < s) {
          const float x = round_to(q[i][u] / ds[u], static_cast<TX*>(nullptr));
          n = fmaf(x, gc[u], n);
        }
      }
      float v = qs[i] - n;
      v = v < 0.f ? 0.f : v;                   // max(v, 0), keeping a NaN
      if (i == 0 || two) {
        ss = fmaf(v, v, ss);
        Q[s * r + (i ? t2 : t)] = v;
      }
    }
  }
  const float tot = block_sum(ss, red);
  if (threadIdx.x == 0) part[(int64_t)c * pm + blockIdx.x] = tot;
}

// The last block's pw columns from j0 normalised from Q into out, a
// thread a row (grid-stride); the last column's divisor is reduced here.
template <typename TX>
__global__ void __launch_bounds__(NORM_THREADS, NORM_COLUMN_BLOCKS)
norm_tail_kernel(const float* __restrict__ Q, TX* __restrict__ out,
                 const float* __restrict__ part, float* __restrict__ dsc,
                 int64_t r, int k, int j0, int pw, int ph, int pc, int pm,
                 float eps) {
  __shared__ float ds[NB];
  previous_divisors(part, dsc, ds, j0 + pw, pw, ph, pc, pm, eps);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * NORM_THREADS;
  for (int64_t t = (int64_t)blockIdx.x * NORM_THREADS + threadIdx.x; t < r;
       t += step) {
    // the row's last sectors into L2 first, so that the partial writes
    // below complete them there (not in a read-modify-write of memory)
    TX* o = out + t * k + j0;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(o));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(o + pw - 1));
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (u < pw) store(o + u, Q[u * r + t] / ds[u]);
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

template <typename TX, typename TR, int TPR>
cudaError_t launch_hals_ring(const void* X, const void* G, const void* R,
                             void* out, int64_t r, int64_t k, float eps,
                             int rows, int stages, int gblocks, int blocks,
                             int vec, int direct, cudaStream_t s) {
  const HalsLayout L = hals_layout(k, rows, stages, gblocks, sizeof(TX),
                                   sizeof(TR), direct && sizeof(TX) == 4);
  if (L.total > 232448) return cudaErrorInvalidValue;
  auto kern = &hals_sweep_kernel<TX, TR, TPR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kern<<<blocks, rows * TPR, L.total, s>>>(
      static_cast<const TX*>(X), static_cast<const float*>(G),
      static_cast<const TR*>(R), static_cast<TX*>(out), r, (int)k, stages,
      gblocks, vec, direct, eps);
  return cudaGetLastError();
}

template <typename TX, typename TR>
cudaError_t launch_hals(const void* X, const void* G, const void* R,
                        void* out, void* scratch, int64_t r, int64_t k,
                        float eps, int rows, int stages, int gblocks, int rt,
                        int blocks, int vec, int direct, cudaStream_t s) {
  if (rows == 0) {                     // the row-per-warp kernel
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int64_t tiles = (k + 31) / 32;
    if (tiles > 65535) return cudaErrorInvalidValue;
    float* Gt = static_cast<float*>(scratch);
    luc_transpose_kernel<<<dim3((unsigned)tiles, (unsigned)tiles), 256, 0,
                           s>>>(static_cast<const float*>(G), Gt, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    hals_rowwise_kernel<TX, TR><<<blocks, WIDE_THREADS, 0, s>>>(
        static_cast<const TX*>(X), Gt, static_cast<const TR*>(R),
        static_cast<TX*>(out), r, k, eps);
    return cudaGetLastError();
  }
  const int nb = (int)((k + HB - 1) / HB);
  if (stages < 1 || stages > 3 || (rt != 1 && rt != 4) || rows * rt % 32 ||
      rows * rt > HALS_MAX_THREADS || (gblocks != 1 && gblocks != nb))
    return cudaErrorInvalidValue;
  if (rt == 4)
    return launch_hals_ring<TX, TR, 4>(X, G, R, out, r, k, eps, rows, stages,
                                       gblocks, blocks, vec, direct, s);
  return launch_hals_ring<TX, TR, 1>(X, G, R, out, r, k, eps, rows, stages,
                                     gblocks, blocks, vec, direct, s);
}

template <typename TX, typename TR>
cudaError_t launch_op(int op, const void* X, const void* G, const void* R,
                      void* out, void* scratch, int64_t r, int64_t k,
                      float eps, int rows, int stages, int chunk, int rt,
                      int blocks, int vec, int direct, cudaStream_t s) {
  if (op == 0)
    return launch_mu<TX, TR>(X, G, R, out, r, k, eps, rows, stages, chunk, rt,
                             blocks, vec, direct, s);
  return launch_hals<TX, TR>(X, G, R, out, scratch, r, k, eps, rows, stages,
                             chunk, rt, blocks, vec, direct, s);
}


// The normalised sweep: per block of NB columns a head pass, then a column
// pass for each of its other columns; then the tail pass.  k + 1 launches
// on the stream, in order (each reads what the ones before it wrote).
// rows = 0: the head passes are norm_head_wide_kernel's.
template <typename TX, typename TR>
cudaError_t launch_hals_norm(const void* X, const void* G, const void* R,
                             void* out, float* Q, float* part, float* dsc,
                             int64_t r, int64_t k, float eps, int rows,
                             int ph, int pc, cudaStream_t s) {
  const bool wide = rows == 0;
  if ((!wide && (rows < 32 || rows > NORM_MAX_THREADS || rows % 32)) ||
      ph < 1 || pc < 1 || k > 0x7fffffff)
    return cudaErrorInvalidValue;
  const NormLayout L = norm_layout(k, wide ? 32 : rows);
  auto head = &norm_head_kernel<TX, TR>;
  cudaError_t err = cudaSuccess;
  if (!wide) {
    if (L.total > 232448) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(
        head, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return err;
  }
  const int kk = (int)k, pm = ph > pc ? ph : pc;
  const TX* x = static_cast<const TX*>(X);
  TX* o = static_cast<TX*>(out);
  const float* g = static_cast<const float*>(G);
  const TR* rr = static_cast<const TR*>(R);
  for (int j0 = 0; j0 < kk; j0 += NB) {
    if (wide)
      norm_head_wide_kernel<TX, TR><<<ph, NORM_THREADS, 0, s>>>(
          j0 ? o : x, rr, g, o, Q, part, dsc, r, kk, j0, j0 ? NB : 0, ph,
          pc, pm, eps, j0 == 0);
    else
      head<<<ph, rows, L.total, s>>>(j0 ? o : x, rr, g, o, Q, part, dsc, r,
                                     kk, j0, j0 ? NB : 0, ph, pc, pm, eps,
                                     j0 == 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int w = kk - j0 < NB ? kk - j0 : NB;
    for (int c = 1; c < w; ++c) {
      norm_column_kernel<TX><<<pc, NORM_THREADS, 0, s>>>(
          Q, g, part, dsc, r, kk, j0, c, ph, pc, pm, eps);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  const int last = (kk - 1) / NB * NB;
  norm_tail_kernel<TX><<<pc, NORM_THREADS, 0, s>>>(
      Q, o, part, dsc, r, kk, last, kk - last, ph, pc, pm, eps);
  return cudaGetLastError();
}

}  // namespace

// The columns of one block of hals_sweep_kernel's sweep (ops.HALS_BLOCK);
// of the normalised sweep's (ops.HALS_NORM_BLOCK), the threads of its
// column passes (HALS_NORM_THREADS), the most rows of its head pass's tile
// (max(HALS_NORM_ROWS)), and the blocks of each an SM holds
// (HALS_NORM_HEAD_PER_SM, HALS_NORM_COLUMN_PER_SM).
extern "C" int luc_tiles(int* out) {
  out[0] = HB;
  out[1] = NB;
  out[2] = NORM_THREADS;
  out[3] = NORM_MAX_THREADS;
  out[4] = NORM_HEAD_BLOCKS;
  out[5] = NORM_COLUMN_BLOCKS;
  return 0;
}

// op 0: mu_update on the plan (rows, stages, chunk, rt, blocks, vec,
// direct) of ops.plan_mu_update; rows = 0 takes the row-per-warp kernel
// on `blocks` blocks.  op 1: hals_sweep on the plan (rows, stages,
// gblocks in `chunk`, tpr in `rt`, blocks, vec, direct) of
// ops.plan_hals_sweep; rows = 0 takes the row-per-warp kernel on `blocks`
// blocks, with `scratch` holding k × k fp32.  X and out (r, k) of x_dtype, R (r, k) of
// r_dtype (fp32, or X's dtype), G (k, k) fp32, all contiguous; out may not
// alias X or R.  Dtype codes: 0 fp32, 1 bf16.
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

// hals_sweep_norm on the plan (rows, ph, pc) of ops.plan_hals_sweep_norm:
// head passes of `rows` threads on `ph` blocks (rows = 0: the wide head
// pass, NORM_THREADS threads a block), column and tail passes on `pc`
// blocks.  X and out (r, k) of x_dtype, R (r, k) of r_dtype (fp32, or
// X's dtype), G (k, k) fp32, all contiguous; out may not alias X or R.
// Scratch, fp32: Q (NB, r), part (k, max(ph, pc)), dsc (k).
extern "C" int hals_norm_launch(int x_dtype, int r_dtype, const void* X,
                                const void* G, const void* R, void* out,
                                float* Q, float* part, float* dsc, int64_t r,
                                int64_t k, float eps, int rows, int ph,
                                int pc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || r < 1) return (int)cudaErrorInvalidValue;
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro_torch::kF32 && r_dtype == repro_torch::kF32)
    return (int)launch_hals_norm<float, float>(X, G, R, out, Q, part, dsc, r,
                                               k, eps, rows, ph, pc, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kF32)
    return (int)launch_hals_norm<bf16, float>(X, G, R, out, Q, part, dsc, r,
                                              k, eps, rows, ph, pc, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kBF16)
    return (int)launch_hals_norm<bf16, bf16>(X, G, R, out, Q, part, dsc, r,
                                             k, eps, rows, ph, pc, s);
  return (int)cudaErrorInvalidValue;
}
