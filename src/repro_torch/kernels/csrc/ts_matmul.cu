// Tall-skinny products of the AU-NMF iteration on Hopper (sm_90a):
//
//   ts_matmul    C (m, k) = A (m, n) · B (n, k)    — the W-step product A·Hᵀ,
//                and a served batch's R = a·Hᵀ (rows) or a·W (columns)
//   ts_matmul_t  Y (n, k) = Aᵀ · B, B (m, k)       — the H-step product AᵀW,
//                contracting A's rows so Aᵀ is never materialised
//
// Replaces the TPU kernels `_ab_kernel` / `ts_matmul` and `_atb_kernel` /
// `ts_matmul_t` of src/repro/kernels/ts_matmul.py (pallas_call at :44, :76).
//
// Bound at the main path's shape (m = 1,013,400, n = 13,824, k = 50, fp32,
// H100 SXM): reading A's 56.0 GB once at 3.35 TB/s is 16.7 ms; 2·m·n·k =
// 1.40 TFLOP is 20.9 ms on the CUDA cores' 67 TFLOP/s, and three TF32
// products of it (3xTF32, below) 8.5 ms at the tensor cores' 495 TFLOP/s.
// At a served column batch (b ≤ 256 rows × 1,013,400) the bound is bytes,
// ≈ 0.37 ms at b = 256.
//
// ts_matmul (ts_matmul_tc_kernel) — a pipelined tensor-core product:
//  * Tensor cores at fp32 accuracy (3xTF32).  Each fp32 operand x is split
//    into big = tf32(x) and small = x − big (common.cuh); each 8-deep step
//    adds small·big + big·small + big·big with mma.sync m16n8k8 tf32.  A
//    bf16 operand is exact in tf32: one product per pair.  The mma sums of
//    one BK-deep stage are added into fp32 accumulators with an ordinary
//    (round-to-nearest) add after each stage, so the tensor cores' own
//    accumulation never runs over more than 12 products.
//  * The output tile is BM = 128 rows × k in n8 steps (k = 50 → 56
//    columns); k > 64 takes further 64-column tiles over blockIdx.y.  Each
//    of the 4 warps owns 32 rows: two m16 tiles × up to eight n8 tiles.
//  * A and B (Hᵀ) tiles reach shared memory by cp.async in a ring of
//    STAGES buffers, with no register round trip: A in 16-byte copies when
//    every row of A starts 16-byte aligned, else in 4-byte copies (chosen
//    at launch; see copy_word in common.cuh); B in 4-byte copies.  The contraction's ragged
//    tail and rows past m arrive as zeros.
//  * Split contraction.  When the output's tiles cannot fill the card (a
//    served batch has one or two row tiles), the wrapper splits n into
//    slabs on blockIdx.z; each writes an fp32 partial to scratch (S, m, k)
//    and slab_reduce_warp_kernel sums them in a fixed order.  No atomics:
//    runs are reproducible bit for bit.
//
// ts_matmul_t (skinny_matmul_kernel<T, true>) — register-tiled fp32 FMAs:
//  * A is read exactly once.  Each block owns one BM-row tile of the output
//    and loops over its slab of the contraction; A and B tiles are staged
//    through shared memory; the (BM × BN) output tile stays in registers,
//    TM × TN = 8 × 4 per thread.  k is tiled by BN = 64 over blockIdx.y.
//  * It contracts over m ≈ 1 M rows, and a grid over n-tiles alone has
//    only ~108 blocks, so m is split into S slabs (blockIdx.z) and
//    slab_reduce_kernel sums the (S, n, k) partials in a fixed order.
//  * Ragged edges are masked inside the kernel: A is never padded or
//    copied.  Loads are scalar and coalesced along A's rows.
//  * Each thread loads the next stage's A and B elements into registers
//    while it runs the current stage's FMAs from shared memory.
#include "common.cuh"

namespace {

using repro_torch::lmin;
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

// ---------------------------------------------------------------------------
// ts_matmul on the tensor cores
// ---------------------------------------------------------------------------

constexpr int STAGES = 4;            // ring buffers of A and B tiles
constexpr int TC_WARPS = BM / 32;    // each warp: 32 rows of the tile
constexpr int TC_THREADS = TC_WARPS * 32;

// Shared-memory row strides in elements: a row of BK (A) or BN (B) values
// plus the lead-in of a 4-byte copy, 16-byte aligned, and chosen so the
// mma fragment reads fall on distinct banks.
template <typename T> struct Lds;
template <> struct Lds<float> { static constexpr int A = BK + 4, B = BN + 8; };
template <> struct Lds<__nv_bfloat16> {
  static constexpr int A = BK + 8, B = BN + 8;
};

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (BM * Lds<T>::A + BK * Lds<T>::B) * (int)sizeof(T);
}

// d += a·b on the tensor cores (m16n8k8, tf32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[z] (m, k) = sum over d in slab z of A[r, d] · B[d, c], for the
// BN-column tile blockIdx.y, of which the first NT n8 tiles are computed
// (NT is a template parameter: guards around single mma instructions would
// stop the compiler from pipelining them).  A is copied in 16-byte chunks
// when `a16` (every row of A starts 16-byte aligned), else in 4-byte words;
// B likewise by `b16`.  For k ≤ BN a stage of B — BK rows of k — is one
// contiguous range, copied flat (row stride k in shared memory); wider k
// copies each row's 64-column segment in 4-byte words.
template <typename T, int NT>
__global__ void __launch_bounds__(TC_THREADS, 2)
ts_matmul_tc_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    float* __restrict__ out, int64_t m, int64_t n, int64_t k,
                    int64_t slab, bool a16, bool b16) {
  constexpr bool SPLIT = sizeof(T) == 4;                 // fp32: 3xTF32
  constexpr bool BF16 = sizeof(T) == 2;                  // lead-ins possible
  constexpr int LA = Lds<T>::A, LB = Lds<T>::B;
  constexpr int ES = (int)sizeof(T);
  // words per row of a 4-byte copy: the row's bytes plus a lead-in word
  constexpr int NWA = BK * ES / 4 + 1;
  constexpr int NWB = BN * ES / 4 + 1;
  // 16-byte copies of A: chunks per row, and a thread's chunks, RSTEP rows
  // apart in one chunk column
  constexpr int CPR = BK * ES / 16;
  constexpr int RSTEP = TC_THREADS / CPR;
  constexpr int ACH = BM / RSTEP;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;        // mma groupID
  const int t = lane % 4;        // mma thread in group
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int64_t col0 = (int64_t)blockIdx.y * BN;
  const int64_t d_begin = (int64_t)blockIdx.z * slab;
  const int64_t d_end = d_begin + slab < n ? d_begin + slab : n;
  const int64_t ncols = k - col0 < BN ? k - col0 : BN;
  const int64_t nstages = d_begin < d_end ? (d_end - d_begin + BK - 1) / BK : 0;
  const uintptr_t a_base = reinterpret_cast<uintptr_t>(A);
  const uintptr_t b_base = reinterpret_cast<uintptr_t>(B);
  const bool flat_b = k <= BN;
  const int ldb = flat_b ? (int)k : LB;
  // A tile with at most 64 rows below m (a served batch) shares each row
  // group of 32 among kw = 4 or 2 warps, each taking every kw-th k8 step of
  // a stage, summed in a fixed order at the end; otherwise each warp owns
  // 32 rows.  A warp whose rows all lie past m runs no mma.
  const int64_t tile_rows = m - row0;
  const int kw = tile_rows <= 32 ? 4 : (tile_rows <= 64 ? 2 : 1);
  const int wrow = (warp / kw) * 32;        // first row of the warp's group
  const int kpart = warp % kw;
  const bool busy = tile_rows - wrow > 0;

  // this thread's 16-byte A chunks: column a_c, rows a_r + i·RSTEP
  const int a_c = tid % CPR;
  const int a_r = tid / CPR;
  const T* a_src = A + (row0 + a_r) * n + a_c * (16 / ES);
  const int64_t a_left = m - row0 - a_r;
  const int a_rows = a_left <= 0 ? 0
                     : (int)lmin(ACH, (a_left + RSTEP - 1) / RSTEP);

  // Stage st (contraction [d0, d0 + BK)) → ring buffer st % STAGES.
  auto fetch = [&](int64_t st) {
    const int64_t d0 = d_begin + st * BK;
    const int64_t dk = d_end - d0 < BK ? d_end - d0 : BK;
    char* as = smem + (st % STAGES) * stage_bytes<T>();
    char* bs = as + BM * LA * ES;
    if (a16) {
      const int64_t cbytes = (dk - a_c * (16 / ES)) * ES;
      const int cv = cbytes <= 0 ? 0 : (cbytes >= 16 ? 16 : (int)cbytes);
#pragma unroll
      for (int i = 0; i < ACH; ++i) {
        const bool ok = i < a_rows && cv > 0;
        repro_torch::cp_async16(
            as + ((a_r + i * RSTEP) * LA + a_c * (16 / ES)) * ES,
            ok ? (const void*)(a_src + d0 + (int64_t)i * RSTEP * n) : A,
            ok ? cv : 0);
      }
    } else {
      for (int idx = tid; idx < BM * NWA; idx += TC_THREADS) {
        const int r = idx / NWA, j = idx % NWA;
        const uintptr_t src = a_base + ((row0 + r) * n + d0) * ES;
        if (j < repro_torch::words_for<4>(src, BK * ES))
          repro_torch::copy_word<4>(as + r * LA * ES, src,
                                    row0 + r < m ? dk * ES : 0, j, A);
      }
    }
    if (flat_b) {
      const uintptr_t src = b_base + d0 * k * ES;
      const int64_t bytes = BK * k * ES, valid = dk * k * ES;
      if (b16) {
        for (int64_t j = tid; j < bytes / 16; j += TC_THREADS)
          repro_torch::copy_word<16>(bs, src, valid, j, B);
      } else {
        const int64_t words = repro_torch::words_for<4>(src, bytes);
        for (int64_t j = tid; j < words; j += TC_THREADS)
          repro_torch::copy_word<4>(bs, src, valid, j, B);
      }
    } else {
      for (int idx = tid; idx < BK * NWB; idx += TC_THREADS) {
        const int r = idx / NWB, j = idx % NWB;
        const uintptr_t src = b_base + ((d0 + r) * k + col0) * ES;
        if (j < repro_torch::words_for<4>(src, ncols * ES))
          repro_torch::copy_word<4>(bs + r * LB * ES, src,
                                    r < dk ? ncols * ES : 0, j, B);
      }
    }
  };

  // The lead-in (in elements) of each A row this lane reads, rows
  // warp·32 + 8i + g, i < 4: nonzero only for bf16 in 4-byte words, and
  // constant over the stages (d0 is a multiple of BK).  B's flat stage
  // starts at b_base + d0·k·ES, a multiple of 16 bytes past b_base: one
  // lead-in for every stage; B's rows (k > BN) each have their own.
  int sha[4] = {0, 0, 0, 0};
  int shb_flat = 0;
  if (BF16 && !a16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sha[i] = (int)(((a_base + (row0 + wrow + 8 * i + g) * n * ES) & 3) / ES);
  }
  if (BF16 && flat_b && !b16) shb_flat = (int)((b_base & 3) / ES);

  float acc[2][NT][4];
  float part[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nstages) fetch(st);
    repro_torch::cp_async_commit();
  }
  for (int64_t st = 0; st < nstages; ++st) {
    repro_torch::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nstages) fetch(st + STAGES - 1);
    repro_torch::cp_async_commit();
    if (!busy) continue;

    const T* as = reinterpret_cast<const T*>(smem + (st % STAGES) *
                                                        stage_bytes<T>());
    const T* bs = as + BM * LA;
    const int64_t d0 = d_begin + st * BK;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (ks % kw != kpart) continue;
      // A fragments (row-major 16×8): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
      // a3 (g+8, t+4) of each m16 tile.
      unsigned abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 2 * mt + (e & 1);                 // row 8·ri + g
          const int r = wrow + 8 * ri + g;
          const int c = ks * 8 + t + (e >> 1) * 4;
          const float x = to_f32(as[r * LA + sha[ri] + c]);
          if (SPLIT) {
            const float big = repro_torch::tf32_big(x);
            abig[mt][e] = __float_as_uint(big);
            asmall[mt][e] = __float_as_uint(x - big);
          } else {
            abig[mt][e] = __float_as_uint(x);
          }
        }
      }
      // B fragments (col-major 8×8): b0 (t, g), b1 (t+4, g).
      int shb0 = shb_flat, shb1 = shb_flat;
      if (BF16 && !flat_b) {
        const int64_t d = d0 + ks * 8 + t;
        shb0 = (int)(((b_base + (d * k + col0) * ES) & 3) / ES);
        shb1 = (int)(((b_base + ((d + 4) * k + col0) * ES) & 3) / ES);
      }
      const T* b0row = bs + (ks * 8 + t) * ldb + shb0 + g;
      const T* b1row = bs + (ks * 8 + t + 4) * ldb + shb1 + g;
      unsigned bbig[NT][2], bsmall[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float x0 = to_f32(b0row[nt * 8]);
        const float x1 = to_f32(b1row[nt * 8]);
        if (SPLIT) {
          const float big0 = repro_torch::tf32_big(x0);
          const float big1 = repro_torch::tf32_big(x1);
          bbig[nt][0] = __float_as_uint(big0);
          bbig[nt][1] = __float_as_uint(big1);
          bsmall[nt][0] = __float_as_uint(x0 - big0);
          bsmall[nt][1] = __float_as_uint(x1 - big1);
        } else {
          bbig[nt][0] = __float_as_uint(x0);
          bbig[nt][1] = __float_as_uint(x1);
        }
      }
      // One pass per product, so consecutive mma feed different
      // accumulators; the small products first.
#pragma unroll
      for (int pass = 0; pass < (SPLIT ? 3 : 1); ++pass) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned(&a)[4] = SPLIT && pass == 0 ? asmall[mt] : abig[mt];
            const unsigned(&b)[2] = SPLIT && pass == 1 ? bsmall[nt] : bbig[nt];
            mma_tf32(part[mt][nt], a, b[0], b[1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
  repro_torch::cp_async_wait<0>();

  // Warps sharing a row group: parts 1..kw−1 added to part 0 in order.
  if (kw > 1) {
    __syncthreads();                          // the ring is free again
    float* red = reinterpret_cast<float*>(smem);   // [part−1][group][..][lane]
    constexpr int PER = 2 * NT * 4;
    const int group = warp / kw;
    auto slot = [&](int p, int i) {
      return (((p - 1) * (TC_WARPS / kw) + group) * PER + i) * 32 + lane;
    };
    if (kpart > 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[slot(kpart, (mt * NT + nt) * 4 + e)] = acc[mt][nt][e];
    }
    __syncthreads();
    if (kpart > 0) return;
    for (int p = 1; p < kw; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] += red[slot(p, (mt * NT + nt) * 4 + e)];
  }

  // D fragments: d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
  float* dst = out + (int64_t)blockIdx.z * m * k;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t r = row0 + wrow + mt * 16 + g + (e >> 1) * 8;
      if (r >= m) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int64_t c = col0 + nt * 8 + 2 * t + (e & 1);
        if (c < k) dst[r * k + c] = acc[mt][nt][e];
      }
    }
  }
}

// The n8 tiles a launch computes: the fewest of {1, 2, 4, 7, 8} that cover
// min(k, BN) columns (k = 50 → 7 tiles, 56 columns).
inline int n8_tiles(int64_t k) {
  const int64_t need = (lmin(k, BN) + 7) / 8;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 7 ? 7 : 8;
}

template <typename T, int NT>
cudaError_t launch_tc(const void* A, const void* B, float* out, int64_t m,
                      int64_t n, int64_t k, int64_t slab, int64_t slabs,
                      bool a16, bool b16, cudaStream_t stream) {
  auto kern = ts_matmul_tc_kernel<T, NT>;
  const int smem = STAGES * stage_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((k + BN - 1) / BN),
                  (unsigned)slabs);
  kern<<<grid, TC_THREADS, smem, stream>>>(static_cast<const T*>(A),
                                           static_cast<const T*>(B), out, m, n,
                                           k, slab, a16, b16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(bool a16, bool b16, const void* A, const void* B,
                      float* out, int64_t m, int64_t n, int64_t k,
                      int64_t slab, int64_t slabs, cudaStream_t stream) {
  switch (n8_tiles(k)) {
    case 1:
      return launch_tc<T, 1>(A, B, out, m, n, k, slab, slabs, a16, b16, stream);
    case 2:
      return launch_tc<T, 2>(A, B, out, m, n, k, slab, slabs, a16, b16, stream);
    case 4:
      return launch_tc<T, 4>(A, B, out, m, n, k, slab, slabs, a16, b16, stream);
    case 7:
      return launch_tc<T, 7>(A, B, out, m, n, k, slab, slabs, a16, b16, stream);
    default:
      return launch_tc<T, 8>(A, B, out, m, n, k, slab, slabs, a16, b16, stream);
  }
}

cudaError_t launch_t(int dtype, const void* A, const void* B, float* out,
                     int64_t rows, int64_t depth, int64_t k, int64_t lda,
                     int64_t slab, int64_t slabs, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + BM - 1) / BM),
                  (unsigned)((k + BN - 1) / BN), (unsigned)slabs);
  if (dtype == repro_torch::kF32) {
    skinny_matmul_kernel<float, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), out, rows,
        depth, k, lda, slab);
  } else if (dtype == repro_torch::kBF16) {
    skinny_matmul_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), out, rows, depth, k, lda, slab);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The tile sizes the wrapper plans its slabs with: (rows, columns of k,
// contraction depth per stage) of a block, shared by both kernels; and the
// ring's stages of ts_matmul.
extern "C" int ts_matmul_tiles(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = STAGES;
  return 0;
}

// C (m, k) fp32 = A (m, n) · B (n, k); A and B contiguous, same dtype.
// The contraction is cut into `slabs` slabs of `slab` (a multiple of BK);
// with slabs > 1 the partials go to scratch (slabs, m, k) and are then
// reduced into C.  a16: 16-byte copies of A (every row of A starts
// 16-byte aligned), else 4-byte copies; b16: B 16-byte aligned.
extern "C" int ts_matmul_launch(int dtype, const void* A, const void* B,
                                void* C, void* scratch, int64_t m, int64_t n,
                                int64_t k, int64_t slab, int64_t slabs,
                                int a16, int b16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slabs > 1 ? scratch : C);
  cudaError_t err;
  if (dtype == repro_torch::kF32)
    err = launch_tc<float>(a16 != 0, b16 != 0, A, B, dst, m, n, k, slab,
                           slabs, s);
  else if (dtype == repro_torch::kBF16)
    err = launch_tc<__nv_bfloat16>(a16 != 0, b16 != 0, A, B, dst, m, n, k,
                                   slab, slabs, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)repro_torch::launch_slab_reduce_warp(
      dst, static_cast<float*>(C), m * k, slabs, s);
}

// Y (n, k) fp32 = Aᵀ · B for A (m, n), B (m, k).  With slabs > 1 the slab
// partials go to scratch (slabs, n, k) and are then reduced into Y.
extern "C" int ts_matmul_t_launch(int dtype, const void* A, const void* B,
                                  void* Y, void* scratch, int64_t m,
                                  int64_t n, int64_t k, int64_t slab,
                                  int64_t slabs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slabs > 1 ? scratch : Y);
  cudaError_t err = launch_t(dtype, A, B, dst, n, m, k, n, slab, slabs, s);
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)repro_torch::launch_slab_reduce(dst, static_cast<float*>(Y),
                                              n * k, slabs, s);
}
