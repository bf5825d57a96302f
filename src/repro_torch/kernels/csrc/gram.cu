// Gram matrix G (k, k) = Xᵀ X of a tall-skinny factor panel X (r, k) on
// Hopper (sm_90a) — the products HHᵀ (X = Hᵀ) and WᵀW of every iteration.
//
// Replaces the TPU kernel `_gram_kernel` / `gram` of
// src/repro/kernels/gram.py (pallas_call at :42).
//
// Bound at the main path's shapes (H100 SXM, fp32): XᵀX is symmetric, so
// gram(W) with r = 1,013,400 and k = 50 needs r·k·(k+1) = 2.58 GFLOP
// (0.039 ms at 67 TFLOP/s on the CUDA cores; three TF32 products of it,
// 0.016 ms at the tensor cores' 495 TFLOP/s) and reads 0.20 GB (0.061 ms
// at 3.35 TB/s): bound by bytes at 0.061 ms.  gram(Hᵀ) with r = 13,824 is
// a few microseconds of work: launch-bound.
//
// Design against that bound — a streaming Gram that reads X once:
//  * Persistent grid.  The rows are cut into S slabs (blockIdx.x), about
//    three blocks per SM in all; each block owns a contiguous slab.  For
//    k ≤ 64 there is one block column; larger k is tiled into 64-column
//    super tiles and blockIdx.y walks the pairs (a ≥ b) of them, each
//    reading the slab again.
//  * Streaming.  The slab's rows go through shared memory in panels of P
//    rows — P·k contiguous elements — in a ring of STAGES buffers filled by
//    cp.async: 16-byte copies when every panel starts 16-byte aligned,
//    4-byte copies otherwise (chosen at launch from X's address and P·k).
//    Each panel is loaded once, and the next STAGES−1 are in flight while
//    one is summed.
//  * Tensor cores at fp32 accuracy (3xTF32, as ts_matmul.cu).  XᵀX over an
//    8-row step is an m16n8k8 product whose A operand (columns of X as
//    rows) and B operand are read from the same loads, so a lane loads and
//    splits 16 values a step.  Only the m16 × n8 tiles that hold an entry
//    a ≥ b are multiplied: 20 of the 32 of the padded 64 × 64 square at
//    k = 50.  (8×8 register tiles of fp32 FMAs, tried first, were bound by
//    their compute: chip_smoke.py timed them at 2.7× the bytes bound.)
//    Each step's three products start from zero and are added into fp32
//    accumulators with an ordinary add, so the tensor cores never sum more
//    than 24 products.  The 4 warps take alternate 8-row steps and are
//    summed in a fixed order at the end; each a ≥ b entry is written to
//    G[a][b] and mirrored to G[b][a]: exactly symmetric.
//  * Reduction.  The slab partials (lower triangle) go to scratch
//    (S, k, k); gram_reduce_kernel gives each output entry a warp whose
//    lanes stride over the slabs and combine in a fixed butterfly.  No
//    atomics: runs are reproducible bit for bit.
//  * Ragged edges: a short last panel arrives zero-filled past its last
//    row; columns past k are read (from the next row or the buffer's
//    slack) but their outputs are never written.  X is never padded or
//    copied.
#include "common.cuh"

namespace {

using repro_torch::copy_word;
using repro_torch::lmin;
using repro_torch::to_f32;
using repro_torch::words_for;

constexpr int STAGES = 4;     // panels in the ring
constexpr int SUPER = 64;     // columns of a super tile (k > 64 tiles by it)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// (a, b) with a ≥ b for the lower-triangle index e = a(a+1)/2 + b.
__device__ __forceinline__ void tri_index(int64_t e, int64_t* a, int64_t* b) {
  int64_t i = (int64_t)((sqrt(8.0 * (double)e + 1.0) - 1.0) / 2.0);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  *a = i;
  *b = e - i * (i + 1) / 2;
}

// d += a·b on the tensor cores (m16n8k8, tf32 in, fp32 accumulate); the
// _zero form starts from d = 0.
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], unsigned a0,
                                              unsigned a1, unsigned a2,
                                              unsigned a3, unsigned b0,
                                              unsigned b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(z));
}

// One side of a k8 step: X[row][c0 + 8j + g] for the rows t and t + 4 of
// the step, j < 8, split for 3xTF32 (fp32) or taken whole (bf16).
template <typename T, int NV>
struct Side {
  unsigned big[2][NV], small[2][NV];

  __device__ __forceinline__ void load(const T* x0, const T* x1) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = to_f32((h ? x1 : x0)[8 * j]);
        if (sizeof(T) == 4) {
          const float b = repro_torch::tf32_big(v);
          big[h][j] = __float_as_uint(b);
          small[h][j] = __float_as_uint(v - b);
        } else {
          big[h][j] = __float_as_uint(v);
        }
      }
    }
  }
};

// out = the slab's lower-triangle partial Gram (rows [z·slab, z·slab +
// slab) of X), written to out[z] (scratch) or, with `mirror`, straight to G
// with both halves.  The output of super-tile pair (A, B) (blockIdx.y) is
// cut into m16 × n8 tiles, MT = NT / 2 by NT: for k ≤ 64 (FULL false, one
// pair) only the tiles that hold an entry a ≥ b; for k > 64 (FULL) all 4 × 8
// of every pair.  Each warp takes every WARPS-th 8-row step of a panel.
// stage_bytes: the stride of the ring's buffers.
template <typename T, int NT, bool FULL>
__global__ void __launch_bounds__(THREADS, FULL ? 2 : 3)
gram_kernel(const T* __restrict__ X, float* __restrict__ out, int64_t r,
            int64_t k, int64_t slab, int panel, int64_t stage_bytes,
            bool vec, bool mirror) {
  constexpr int MT = NT / 2;
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;        // mma groupID
  const int t = lane % 4;        // mma thread in group
  int64_t A, B;
  tri_index(blockIdx.y, &A, &B);
  const int64_t ca = A * SUPER;   // first column of each side
  const int64_t cb = B * SUPER;

  const int64_t row_begin = (int64_t)blockIdx.x * slab;
  const int64_t row_end = lmin(row_begin + slab, r);
  const int64_t npanels =
      row_begin < row_end ? (row_end - row_begin + panel - 1) / panel : 0;
  const int64_t panel_bytes = (int64_t)panel * k * sizeof(T);

  // Panel p of the slab → ring buffer p % STAGES; the rows past the slab's
  // end arrive as zeros.
  auto fetch = [&](int64_t p) {
    const int64_t row0 = row_begin + p * panel;
    const int64_t bytes = lmin(panel, row_end - row0) * k * sizeof(T);
    const uintptr_t src = reinterpret_cast<uintptr_t>(X + row0 * k);
    char* dst = smem + (p % STAGES) * stage_bytes;
    if (vec) {
      for (int64_t j = tid; j < panel_bytes / 16; j += THREADS)
        copy_word<16>(dst, src, bytes, j, X);
    } else {
      const int64_t words = words_for<4>(src, panel_bytes);
      for (int64_t j = tid; j < words; j += THREADS)
        copy_word<4>(dst, src, bytes, j, X);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < npanels) fetch(st);
    repro_torch::cp_async_commit();
  }
  for (int64_t p = 0; p < npanels; ++p) {
    repro_torch::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (p + STAGES - 1 < npanels) fetch(p + STAGES - 1);
    repro_torch::cp_async_commit();
    const uintptr_t src =
        reinterpret_cast<uintptr_t>(X + (row_begin + p * panel) * k);
    const T* x = reinterpret_cast<const T*>(
        smem + (p % STAGES) * stage_bytes + (src & (vec ? 15 : 3)));
    for (int s = warp; s < panel / 8; s += WARPS) {
      const T* row_t = x + (int64_t)(8 * s + t) * k + g;
      const T* row_t4 = row_t + 4 * k;
      Side<T, NT> vb;
      vb.load(row_t + cb, row_t4 + cb);
      // A (16×8): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of Xᵀ
      // = columns 16i + g (+ 8) of rows t (+ 4); B (8×8): b0 (t, g), b1
      // (t+4, g) = columns 8j + g of rows t, t + 4.  So the B side's loads
      // are the A side's too when both sides are the same columns.
      auto tiles = [&](const auto& va) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (!FULL && j > 2 * i + 1) continue;   // above the diagonal
            const int i0 = 2 * i, i1 = 2 * i + 1;
            float d[4];
            if (SPLIT) {
              mma_tf32_zero(d, va.small[0][i0], va.small[0][i1],
                            va.small[1][i0], va.small[1][i1], vb.big[0][j],
                            vb.big[1][j]);
              mma_tf32(d, va.big[0][i0], va.big[0][i1], va.big[1][i0],
                       va.big[1][i1], vb.small[0][j], vb.small[1][j]);
              mma_tf32(d, va.big[0][i0], va.big[0][i1], va.big[1][i0],
                       va.big[1][i1], vb.big[0][j], vb.big[1][j]);
            } else {
              mma_tf32_zero(d, va.big[0][i0], va.big[0][i1], va.big[1][i0],
                            va.big[1][i1], vb.big[0][j], vb.big[1][j]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      };
      if constexpr (FULL) {
        Side<T, 2 * MT> va;
        va.load(row_t + ca, row_t4 + ca);
        tiles(va);
      } else {
        tiles(vb);
      }
    }
  }
  repro_torch::cp_async_wait<0>();
  __syncthreads();

  // The warps' partials, summed in the order w = 0, 1, ..., WARPS − 1.
  float* red = reinterpret_cast<float*>(smem);   // [warp − 1][i][j][e][lane]
  auto slot = [&](int w, int i, int j, int e) {
    return ((((w - 1) * MT + i) * NT + j) * 4 + e) * 32 + lane;
  };
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[slot(warp, i, j, e)] = acc[i][j][e];
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < WARPS; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += red[slot(w, i, j, e)];

  // D (16×8): d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1).
  float* dst = mirror ? out : out + (int64_t)blockIdx.x * k * k;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t a = ca + 16 * i + g + (e >> 1) * 8;
        const int64_t b = cb + 8 * j + 2 * t + (e & 1);
        if (a >= k || b >= k || b > a) continue;
        dst[a * k + b] = acc[i][j][e];
        if (mirror) dst[b * k + a] = acc[i][j][e];
      }
}

// G[a][b] = G[b][a] = sum over slabs of part[s][a][b], a ≥ b: one warp per
// entry, lanes striding over the slabs, a fixed butterfly across lanes.
__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ G, int64_t k,
                                   int64_t slabs) {
  const int lane = threadIdx.x % 32;
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (e >= k * (k + 1) / 2) return;
  int64_t a, b;
  tri_index(e, &a, &b);
  const int64_t off = a * k + b;
  float acc = 0.f;
  for (int64_t s = lane; s < slabs; s += 32) acc += part[s * k * k + off];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    G[off] = acc;
    G[b * k + a] = acc;
  }
}

int64_t stage_bytes_for(int64_t panel, int64_t k, int64_t esize) {
  // the panel, the copy's lead-in (< 16 bytes) and the overrun of the
  // reads past the last row (columns ≥ k are read, never used)
  const int64_t bytes = (panel * k + SUPER) * esize + 16;
  return (bytes + 15) / 16 * 16;
}

// The n8 tiles of a side: the fewest of {2, 4, 8} that cover min(k, 64)
// columns (k = 50 → 8, of which the lower triangle takes 20 m16×n8 tiles).
inline int n8_tiles(int64_t k) {
  const int64_t need = (lmin(k, SUPER) + 7) / 8;
  return need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

template <typename T, int NT, bool FULL>
cudaError_t launch_main(const void* X, float* out, int64_t r, int64_t k,
                        int64_t slab, int64_t slabs, int panel, bool vec,
                        bool mirror, cudaStream_t stream) {
  const int64_t sup = (k + SUPER - 1) / SUPER;
  const int64_t stage = stage_bytes_for(panel, k, sizeof(T));
  const int64_t red = (int64_t)(WARPS - 1) * (NT / 2) * NT * 4 * 32 * 4;
  const int64_t smem = STAGES * stage > red ? STAGES * stage : red;
  auto kern = gram_kernel<T, NT, FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)slabs, (unsigned)(sup * (sup + 1) / 2));
  kern<<<grid, THREADS, (size_t)smem, stream>>>(
      static_cast<const T*>(X), out, r, k, slab, panel, stage, vec, mirror);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_main(bool vec, const void* X, float* out, int64_t r,
                        int64_t k, int64_t slab, int64_t slabs, int panel,
                        bool mirror, cudaStream_t stream) {
  if (k > SUPER)
    return launch_main<T, 8, true>(X, out, r, k, slab, slabs, panel, vec,
                                   mirror, stream);
  switch (n8_tiles(k)) {
    case 2:
      return launch_main<T, 2, false>(X, out, r, k, slab, slabs, panel, vec,
                                      mirror, stream);
    case 4:
      return launch_main<T, 4, false>(X, out, r, k, slab, slabs, panel, vec,
                                      mirror, stream);
    default:
      return launch_main<T, 8, false>(X, out, r, k, slab, slabs, panel, vec,
                                      mirror, stream);
  }
}

}  // namespace

// The kernel's fixed sizes, for the wrapper's plan: (ring stages, super
// tile edge, threads per block).
extern "C" int gram_tiles(int* out) {
  out[0] = STAGES;
  out[1] = SUPER;
  out[2] = THREADS;
  return 0;
}

// G (k, k) fp32 = Xᵀ X for X (r, k) contiguous, with the wrapper's plan:
// `slabs` slabs of `slab` rows (a multiple of `panel`), panels of `panel`
// rows, 16-byte copies when `vec`.  With slabs > 1 the slab partials go to
// scratch (slabs, k, k) and are then reduced into G.  `parts` runs the main
// kernel (1), the reduction (2) or both (3).
extern "C" int gram_launch(int dtype, const void* X, void* G, void* scratch,
                           int64_t r, int64_t k, int64_t slab, int64_t slabs,
                           int panel, int vec, int parts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool direct = slabs == 1;
  float* dst = static_cast<float*>(direct ? G : scratch);
  cudaError_t err = cudaSuccess;
  if (parts & 1) {
    if (dtype == repro_torch::kF32)
      err = launch_main<float>(vec != 0, X, dst, r, k, slab, slabs, panel,
                               direct, s);
    else if (dtype == repro_torch::kBF16)
      err = launch_main<__nv_bfloat16>(vec != 0, X, dst, r, k, slab, slabs,
                                       panel, direct, s);
    else
      return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 2) && !direct) {
    const int threads = 256;
    const int64_t blocks = (k * (k + 1) / 2 * 32 + threads - 1) / threads;
    gram_reduce_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        dst, static_cast<float*>(G), k, slabs);
    err = cudaGetLastError();
  }
  return (int)err;
}
