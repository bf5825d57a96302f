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
//    bf16 operand is exact in tf32 (its small part is 0): a bf16 pair takes
//    one product, and a bf16 A beside an fp32 B (the H-step's AᵀW of a bf16
//    A and BPP's fp32 W; a bf16 request batch on fp32 factors) two per
//    8-deep step, a·b_small then a·b_big — the fp32 kernel's sums on A
//    widened to fp32, whose first product a_small·b_big adds only zeros,
//    without the widened copy of A.  The mma sums of
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
// ts_matmul_t (ts_matmul_tc_kernel<TA, TB, NT, true>) — the same kernel with A
// read transposed:
//  * The output tile is 128 columns of A (rows of Y) × k; a stage is BK
//    rows of A × those 128 columns, contiguous 512-byte segments (fp32)
//    copied in 16-byte chunks when n % 4 = 0 and A is aligned, else in
//    4-byte words.  Columns past n and rows past the slab arrive as zeros:
//    A is never padded or copied.
//  * The A fragments are read down the stage's columns.  The stage's row
//    stride is 136 elements, ≡ 8 (mod 32) words, so the 32 lanes of a
//    fragment read (4 rows × 8 consecutive columns) hit 32 banks.
//    (ldmatrix.trans cannot transpose 32-bit elements.)
//  * B (W) is (m, k): a stage of it is BK rows of k, one contiguous range,
//    as Hᵀ's is for ts_matmul.
//  * n = 13,824 gives only 108 output tiles, so m is always split into
//    slabs on blockIdx.z (ops.plan_ts_matmul_t: about four blocks per SM,
//    the count that wastes least of the last wave) and
//    slab_reduce_warp_kernel sums the (S, n, k) partials in a fixed order.
#include "common.cuh"

namespace {

using repro_torch::lmin;
using repro_torch::to_f32;

constexpr int BM = 128;     // output rows per block
constexpr int BN = 64;      // output columns (of k) per block
constexpr int BK = 32;      // contraction depth per shared-memory stage

// ---------------------------------------------------------------------------
// ts_matmul on the tensor cores
// ---------------------------------------------------------------------------

constexpr int STAGES = 4;            // ring buffers of A and B tiles
constexpr int TC_WARPS = BM / 32;    // each warp: 32 rows of the tile
constexpr int TC_THREADS = TC_WARPS * 32;

// Shared-memory row strides in elements, each in its operand's type: a row
// of BK (A) or BN (B) values, or for ts_matmul_t a row of BM values of A's
// BK-row stage (AT), plus the lead-in of a 4-byte copy, 16-byte aligned,
// and chosen so the mma fragment reads fall on distinct banks.  AT: the
// transposed fragment reads take rows t (4 of them) × columns g (8
// consecutive), so a stride of 8 (mod 32) words puts the 32 lanes on 32
// banks (fp32 136 words; bf16 68 words, lanes 2j and 2j + 1 sharing one).
template <typename T> struct Lds;
template <> struct Lds<float> {
  static constexpr int A = BK + 4, B = BN + 8, AT = BM + 8;
};
template <> struct Lds<__nv_bfloat16> {
  static constexpr int A = BK + 8, B = BN + 8, AT = BM + 8;
};

// A stage: A's tile in TA (a multiple of 16 bytes), then B's in TB.
template <typename TA, bool TRANS>
__host__ __device__ constexpr int stage_a_bytes() {
  return (TRANS ? BK * Lds<TA>::AT : BM * Lds<TA>::A) * (int)sizeof(TA);
}

template <typename TA, typename TB, bool TRANS>
__host__ __device__ constexpr int stage_bytes() {
  return stage_a_bytes<TA, TRANS>() + BK * Lds<TB>::B * (int)sizeof(TB);
}

// d += a·b on the tensor cores (m16n8k8, tf32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[z] (m, k) = sum over d in slab z of op(A)[r, d] · B[d, c], for the
// BN-column tile blockIdx.y, of which the first NT n8 tiles are computed
// (NT is a template parameter: guards around single mma instructions would
// stop the compiler from pipelining them).  m counts the output's rows and
// n the contraction: op(A)[r, d] = A[r·n + d] for ts_matmul (A (m, n)), and
// A[d·m + r] for ts_matmul_t (TRANS; A (n, m), so Aᵀ·B with A's rows
// contracted).  A's element type TA and B's TB are each fp32 or bf16; an
// fp32 operand is split into big and small tf32 parts (3xTF32), a bf16 one
// is exact in tf32.  A is copied in 16-byte chunks when `a16` (every row of A
// starts 16-byte aligned), else in 4-byte words; B likewise by `b16`.  For
// k ≤ BN a stage of B — BK rows of k — is one contiguous range, copied flat
// (row stride k in shared memory); wider k copies each row's 64-column
// segment in 4-byte words.
template <typename TA, typename TB, int NT, bool TRANS>
__global__ void __launch_bounds__(TC_THREADS, 2)
ts_matmul_tc_kernel(const TA* __restrict__ A, const TB* __restrict__ B,
                    float* __restrict__ out, int64_t m, int64_t n, int64_t k,
                    int64_t slab, bool a16, bool b16) {
  // fp32 operands are split (3xTF32); bf16 ones may need 4-byte lead-ins
  constexpr bool SPLIT_A = sizeof(TA) == 4, SPLIT_B = sizeof(TB) == 4;
  constexpr bool BF16_A = sizeof(TA) == 2, BF16_B = sizeof(TB) == 2;
  // products per 8-deep step: a_small·b_big, a_big·b_small, a_big·b_big
  constexpr int PASSES = 1 + (int)SPLIT_A + (int)SPLIT_B;
  constexpr int LA = TRANS ? Lds<TA>::AT : Lds<TA>::A, LB = Lds<TB>::B;
  constexpr int ESA = (int)sizeof(TA), ESB = (int)sizeof(TB);
  constexpr int SB = stage_bytes<TA, TB, TRANS>();
  // A's stage in shared memory: AROWS rows of ACOLS elements
  constexpr int AROWS = TRANS ? BK : BM, ACOLS = TRANS ? BM : BK;
  // words per row of a 4-byte copy: the row's bytes plus a lead-in word
  constexpr int NWA = ACOLS * ESA / 4 + 1;
  constexpr int NWB = BN * ESB / 4 + 1;
  // 16-byte copies of A: chunks per row, and a thread's chunks, RSTEP rows
  // apart in one chunk column
  constexpr int CPR = ACOLS * ESA / 16;
  constexpr int RSTEP = TC_THREADS / CPR;
  constexpr int ACH = AROWS / RSTEP;
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

  // this thread's 16-byte A chunks: column a_c, rows a_r + i·RSTEP (of A's
  // rows, or with TRANS of the stage's BK rows)
  const int a_c = tid % CPR;
  const int a_r = tid / CPR;
  const TA* a_src = TRANS ? A + a_r * m + row0 + a_c * (16 / ESA)
                          : A + (row0 + a_r) * n + a_c * (16 / ESA);
  const int64_t a_left = m - row0 - a_r;
  const int a_rows = a_left <= 0 ? 0
                     : (int)lmin(ACH, (a_left + RSTEP - 1) / RSTEP);
  // TRANS: the bytes of each stage row that lie in A (columns below m)
  const int64_t t_cbytes = (m - row0 - a_c * (16 / ESA)) * ESA;
  const int t_cv = t_cbytes <= 0 ? 0 : (t_cbytes >= 16 ? 16 : (int)t_cbytes);
  const int64_t t_row_bytes = lmin(m - row0, BM) * ESA;

  // Stage st (contraction [d0, d0 + BK)) → ring buffer st % STAGES.
  auto fetch = [&](int64_t st) {
    const int64_t d0 = d_begin + st * BK;
    const int64_t dk = d_end - d0 < BK ? d_end - d0 : BK;
    char* as = smem + (st % STAGES) * SB;
    char* bs = as + stage_a_bytes<TA, TRANS>();
    if (TRANS && a16) {
      // row a_r + i·RSTEP of the stage: A row d0 + a_r + i·RSTEP, BM
      // columns from row0; rows past the slab and columns past m are zeros
#pragma unroll
      for (int i = 0; i < ACH; ++i) {
        const bool ok = a_r + i * RSTEP < dk && t_cv > 0;
        repro_torch::cp_async16(
            as + ((a_r + i * RSTEP) * LA + a_c * (16 / ESA)) * ESA,
            ok ? (const void*)(a_src + (d0 + (int64_t)i * RSTEP) * m) : A,
            ok ? t_cv : 0);
      }
    } else if (TRANS) {
      for (int idx = tid; idx < BK * NWA; idx += TC_THREADS) {
        const int r = idx / NWA, j = idx % NWA;
        const uintptr_t src = a_base + ((d0 + r) * m + row0) * ESA;
        if (j < repro_torch::words_for<4>(src, BM * ESA))
          repro_torch::copy_word<4>(as + r * LA * ESA, src,
                                    r < dk ? t_row_bytes : 0, j, A);
      }
    } else if (a16) {
      const int64_t cbytes = (dk - a_c * (16 / ESA)) * ESA;
      const int cv = cbytes <= 0 ? 0 : (cbytes >= 16 ? 16 : (int)cbytes);
#pragma unroll
      for (int i = 0; i < ACH; ++i) {
        const bool ok = i < a_rows && cv > 0;
        repro_torch::cp_async16(
            as + ((a_r + i * RSTEP) * LA + a_c * (16 / ESA)) * ESA,
            ok ? (const void*)(a_src + d0 + (int64_t)i * RSTEP * n) : A,
            ok ? cv : 0);
      }
    } else {
      for (int idx = tid; idx < BM * NWA; idx += TC_THREADS) {
        const int r = idx / NWA, j = idx % NWA;
        const uintptr_t src = a_base + ((row0 + r) * n + d0) * ESA;
        if (j < repro_torch::words_for<4>(src, BK * ESA))
          repro_torch::copy_word<4>(as + r * LA * ESA, src,
                                    row0 + r < m ? dk * ESA : 0, j, A);
      }
    }
    if (flat_b) {
      const uintptr_t src = b_base + d0 * k * ESB;
      const int64_t bytes = BK * k * ESB, valid = dk * k * ESB;
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
        const uintptr_t src = b_base + ((d0 + r) * k + col0) * ESB;
        if (j < repro_torch::words_for<4>(src, ncols * ESB))
          repro_torch::copy_word<4>(bs + r * LB * ESB, src,
                                    r < dk ? ncols * ESB : 0, j, B);
      }
    }
  };

  // The lead-in (in elements) of each A row this lane reads, rows
  // warp·32 + 8i + g, i < 4: nonzero only for bf16 in 4-byte words, and
  // constant over the stages (d0 is a multiple of BK).  B's flat stage
  // starts at b_base + d0·k·ES, a multiple of 16 bytes past b_base: one
  // lead-in for every stage; B's rows (k > BN) each have their own.  With
  // TRANS the lane reads stage rows ks·8 + t (+ 4): their lead-in depends
  // only on t's parity (row0·ES and d0·m·ES are multiples of 4), held in
  // sha[0].  Each operand has lead-ins only when it is bf16.
  int sha[4] = {0, 0, 0, 0};
  int shb_flat = 0;
  if (BF16_A && !a16 && TRANS) {
    sha[0] = (int)(((a_base + t * m * ESA) & 3) / ESA);
  } else if (BF16_A && !a16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sha[i] = (int)(((a_base + (row0 + wrow + 8 * i + g) * n * ESA) & 3) /
                     ESA);
  }
  if (BF16_B && flat_b && !b16) shb_flat = (int)((b_base & 3) / ESB);

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

    const TA* as = reinterpret_cast<const TA*>(smem + (st % STAGES) * SB);
    const TB* bs = reinterpret_cast<const TB*>(
        smem + (st % STAGES) * SB + stage_a_bytes<TA, TRANS>());
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
      // a3 (g+8, t+4) of each m16 tile; with TRANS read down the stage's
      // columns (Aᵀ's rows).
      unsigned abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = 2 * mt + (e & 1);                 // row 8·ri + g
          const int r = wrow + 8 * ri + g;
          const int c = ks * 8 + t + (e >> 1) * 4;
          const float x = TRANS ? to_f32(as[c * LA + sha[0] + r])
                                : to_f32(as[r * LA + sha[ri] + c]);
          if (SPLIT_A) {
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
      if (BF16_B && !flat_b) {
        const int64_t d = d0 + ks * 8 + t;
        shb0 = (int)(((b_base + (d * k + col0) * ESB) & 3) / ESB);
        shb1 = (int)(((b_base + ((d + 4) * k + col0) * ESB) & 3) / ESB);
      }
      const TB* b0row = bs + (ks * 8 + t) * ldb + shb0 + g;
      const TB* b1row = bs + (ks * 8 + t + 4) * ldb + shb1 + g;
      unsigned bbig[NT][2], bsmall[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float x0 = to_f32(b0row[nt * 8]);
        const float x1 = to_f32(b1row[nt * 8]);
        if (SPLIT_B) {
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
      // accumulators; the small products first (a_small·b_big when A is
      // split, then a_big·b_small when B is), a_big·b_big last.
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const bool a_small = SPLIT_A && pass == 0;
        const bool b_small = SPLIT_B && pass == (SPLIT_A ? 1 : 0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned(&a)[4] = a_small ? asmall[mt] : abig[mt];
            const unsigned(&b)[2] = b_small ? bsmall[nt] : bbig[nt];
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

template <typename TA, typename TB, int NT, bool TRANS>
cudaError_t launch_tc(const void* A, const void* B, float* out, int64_t m,
                      int64_t n, int64_t k, int64_t slab, int64_t slabs,
                      bool a16, bool b16, cudaStream_t stream) {
  auto kern = ts_matmul_tc_kernel<TA, TB, NT, TRANS>;
  const int smem = STAGES * stage_bytes<TA, TB, TRANS>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((k + BN - 1) / BN),
                  (unsigned)slabs);
  kern<<<grid, TC_THREADS, smem, stream>>>(static_cast<const TA*>(A),
                                           static_cast<const TB*>(B), out, m,
                                           n, k, slab, a16, b16);
  return cudaGetLastError();
}

template <typename TA, typename TB, bool TRANS>
cudaError_t launch_tc(bool a16, bool b16, const void* A, const void* B,
                      float* out, int64_t m, int64_t n, int64_t k,
                      int64_t slab, int64_t slabs, cudaStream_t stream) {
  switch (n8_tiles(k)) {
    case 1:
      return launch_tc<TA, TB, 1, TRANS>(A, B, out, m, n, k, slab, slabs,
                                         a16, b16, stream);
    case 2:
      return launch_tc<TA, TB, 2, TRANS>(A, B, out, m, n, k, slab, slabs,
                                         a16, b16, stream);
    case 4:
      return launch_tc<TA, TB, 4, TRANS>(A, B, out, m, n, k, slab, slabs,
                                         a16, b16, stream);
    case 7:
      return launch_tc<TA, TB, 7, TRANS>(A, B, out, m, n, k, slab, slabs,
                                         a16, b16, stream);
    default:
      return launch_tc<TA, TB, 8, TRANS>(A, B, out, m, n, k, slab, slabs,
                                         a16, b16, stream);
  }
}

// Either product, split or not: with slabs > 1 the slab kernel writes its
// partials to scratch (slabs, rows, k) and slab_reduce_warp_kernel sums them
// into out in a fixed order.  The operand types instantiated: fp32 · fp32,
// bf16 · bf16 and bf16 A · fp32 B (the wrapper widens a bf16 B beside an
// fp32 A, n × k values, and runs fp32 · fp32).
template <bool TRANS>
int launch(int dtype_a, int dtype_b, const void* A, const void* B, void* out,
           void* scratch, int64_t rows, int64_t depth, int64_t k,
           int64_t slab, int64_t slabs, int a16, int b16, void* stream) {
  using bf16 = __nv_bfloat16;
  constexpr int F32 = repro_torch::kF32, BF16 = repro_torch::kBF16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(slabs > 1 ? scratch : out);
  const bool va = a16 != 0, vb = b16 != 0;
  cudaError_t err;
  if (dtype_a == F32 && dtype_b == F32)
    err = launch_tc<float, float, TRANS>(va, vb, A, B, dst, rows, depth, k,
                                         slab, slabs, s);
  else if (dtype_a == BF16 && dtype_b == BF16)
    err = launch_tc<bf16, bf16, TRANS>(va, vb, A, B, dst, rows, depth, k,
                                       slab, slabs, s);
  else if (dtype_a == BF16 && dtype_b == F32)
    err = launch_tc<bf16, float, TRANS>(va, vb, A, B, dst, rows, depth, k,
                                        slab, slabs, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)repro_torch::launch_slab_reduce_warp(
      dst, static_cast<float*>(out), rows * k, slabs, s);
}

}  // namespace

// The tile sizes the wrapper plans its slabs with: (rows, columns of k,
// contraction depth per stage) of a block and the ring's stages, shared by
// both products.
extern "C" int ts_matmul_tiles(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = STAGES;
  return 0;
}

// C (m, k) fp32 = A (m, n) · B (n, k); A and B contiguous, A of dtype code
// dtype_a and B of dtype_b (fp32 · fp32, bf16 · bf16 or bf16 · fp32).
// The contraction is cut into `slabs` slabs of `slab` (a multiple of BK);
// with slabs > 1 the partials go to scratch (slabs, m, k) and are then
// reduced into C.  a16: 16-byte copies of A (every row of A starts
// 16-byte aligned), else 4-byte copies; b16: B 16-byte aligned.
extern "C" int ts_matmul_launch(int dtype_a, int dtype_b, const void* A,
                                const void* B, void* C, void* scratch,
                                int64_t m, int64_t n, int64_t k, int64_t slab,
                                int64_t slabs, int a16, int b16,
                                void* stream) {
  return launch<false>(dtype_a, dtype_b, A, B, C, scratch, m, n, k, slab,
                       slabs, a16, b16, stream);
}

// Y (n, k) fp32 = Aᵀ · B for A (m, n), B (m, k), with the dtype codes of
// ts_matmul_launch; the contraction over m is
// cut into `slabs` slabs of `slab` rows (a multiple of BK), partials in
// scratch (slabs, n, k) when slabs > 1.  a16: 16-byte copies of A (every
// row of A starts 16-byte aligned); b16: B 16-byte aligned.
extern "C" int ts_matmul_t_launch(int dtype_a, int dtype_b, const void* A,
                                  const void* B, void* Y, void* scratch,
                                  int64_t m, int64_t n, int64_t k,
                                  int64_t slab, int64_t slabs, int a16,
                                  int b16, void* stream) {
  return launch<true>(dtype_a, dtype_b, A, B, Y, scratch, n, m, k, slab,
                      slabs, a16, b16, stream);
}
