// The local update computations (LUC) of MU and HALS on Hopper (sm_90a):
// the fused multiplicative update and the sequential HALS column sweep
// (H-step form), for a factor panel X (r, k), its Gram partner G (k, k)
// fp32 and the cross product R (r, k).
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
// (r = 2^24): 10.07 GB, 3.00 ms against 1.25 ms.  Both are bound by bytes.
//
// Design against that bound:
//  * One thread owns one row for the whole update; rows are independent,
//    columns of the sweep are not, so the sweep's column loop runs inside
//    the thread in order.  A block of 128 threads takes a 128-row panel.
//  * The block's panels of X and R are contiguous in device memory and are
//    read once into shared memory as flat arrays (neighbouring threads on
//    neighbouring addresses, 16 loads in flight per thread), laid out with
//    an odd row stride so that the threads' per-row accesses fall in
//    distinct banks.  The output goes back the same way, once.  Ragged
//    edges are masked; nothing is padded in device memory.
//  * G is staged once per block in shared memory as Gᵀ with rows padded to
//    KMAX (≥ k, a multiple of 4) with zeros: column i of G is one
//    contiguous row read with float4 broadcasts.
//  * Each thread keeps its row of X in KMAX registers (zero beyond k), so
//    X·G_i is KMAX register FMAs against broadcast shared loads, in four
//    partial sums to shorten the dependency chain.  The sweep writes the
//    new x_i into its register with an unrolled select (a register array
//    cannot be indexed by the runtime i) and into the shared panel.
//  * KMAX is a template over {16, 32, 64, 128}; k > 128 is refused.
#include "common.cuh"

namespace {

using repro_torch::to_f32;

constexpr int ROWS = 128;     // rows per block, one per thread
constexpr int KMAX_LIMIT = 128;

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// Stage Gᵀ, and the block's X and R panels as fp32; each thread's row of
// X into registers.  Returns the block's row count.
template <typename TX, typename TR, int KMAX>
__device__ __forceinline__ int load_block(const TX* __restrict__ X,
                                          const float* __restrict__ G,
                                          const TR* __restrict__ R,
                                          int64_t r, int k, int ks,
                                          float* gt, float* xp, float* rp,
                                          float (&x)[KMAX]) {
  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * ROWS;
  const int rows = (int)(r - row0 < ROWS ? r - row0 : ROWS);

  for (int e = tid; e < k * KMAX; e += ROWS) {
    const int i = e / KMAX;          // column of G
    const int l = e % KMAX;
    gt[e] = l < k ? G[(int64_t)l * k + i] : 0.f;
  }
  load_panel(X + row0 * k, rows * k, k, ks, xp);
  load_panel(R + row0 * k, rows * k, k, ks, rp);
  __syncthreads();
  if (tid < rows) {
#pragma unroll
    for (int l = 0; l < KMAX; ++l) x[l] = l < k ? xp[tid * ks + l] : 0.f;
  }
  return rows;
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
mu_update_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                 const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                 int k, int ks, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* gt = smem;
  float* xp = gt + (int64_t)k * KMAX;
  float* rp = xp + (int64_t)ROWS * ks;
  float x[KMAX];
  const int rows = load_block<TX, TR, KMAX>(X, G, R, r, k, ks, gt, xp, rp, x);
  const int t = threadIdx.x;
  if (t < rows) {
    // out_j = x_j · (r_j / ((X·G)_j + ε)): the reference's order.  x_j is
    // read from the panel before the thread overwrites it.
    for (int j = 0; j < k; ++j) {
      const float xg = dot_row<KMAX>(x, gt + j * KMAX);
      xp[t * ks + j] = xp[t * ks + j] * (rp[t * ks + j] / (xg + eps));
    }
  }
  __syncthreads();
  store_panel(out + (int64_t)blockIdx.x * ROWS * k, rows * k, k, ks, xp);
}

template <typename TX, typename TR, int KMAX>
__global__ void __launch_bounds__(ROWS)
hals_sweep_kernel(const TX* __restrict__ X, const float* __restrict__ G,
                  const TR* __restrict__ R, TX* __restrict__ out, int64_t r,
                  int k, int ks, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* gt = smem;
  float* xp = gt + (int64_t)k * KMAX;
  float* rp = xp + (int64_t)ROWS * ks;
  float x[KMAX];
  const int rows = load_block<TX, TR, KMAX>(X, G, R, r, k, ks, gt, xp, rp, x);
  const int t = threadIdx.x;
  if (t < rows) {
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
  store_panel(out + (int64_t)blockIdx.x * ROWS * k, rows * k, k, ks, xp);
}

template <typename TX, typename TR, int KMAX>
cudaError_t launch_typed(int op, const void* X, const void* G, const void* R,
                         void* out, int64_t r, int k, float eps,
                         cudaStream_t s) {
  const int ks = k | 1;
  const size_t bytes = (size_t)smem_floats<KMAX>(k, ks) * sizeof(float);
  using Kernel = void (*)(const TX*, const float*, const TR*, TX*, int64_t,
                          int, int, float);
  const Kernel kern = op == 0 ? &mu_update_kernel<TX, TR, KMAX>
                              : &hals_sweep_kernel<TX, TR, KMAX>;
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
cudaError_t launch_k(int op, const void* X, const void* G, const void* R,
                     void* out, int64_t r, int k, float eps, cudaStream_t s) {
  if (k <= 16) return launch_typed<TX, TR, 16>(op, X, G, R, out, r, k, eps, s);
  if (k <= 32) return launch_typed<TX, TR, 32>(op, X, G, R, out, r, k, eps, s);
  if (k <= 64) return launch_typed<TX, TR, 64>(op, X, G, R, out, r, k, eps, s);
  return launch_typed<TX, TR, 128>(op, X, G, R, out, r, k, eps, s);
}

}  // namespace

// The largest k the kernels take.
extern "C" int luc_max_k(int* out) {
  out[0] = KMAX_LIMIT;
  return 0;
}

// op 0: mu_update, 1: hals_sweep.  X and out (r, k) of x_dtype, R (r, k) of
// r_dtype (fp32, or X's dtype), G (k, k) fp32, all contiguous; out may not
// alias X or R.  Dtype codes: 0 fp32, 1 bf16.
extern "C" int luc_launch(int op, int x_dtype, int r_dtype, const void* X,
                          const void* G, const void* R, void* out, int64_t r,
                          int64_t k, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((op != 0 && op != 1) || k < 1 || k > KMAX_LIMIT || r < 1)
    return (int)cudaErrorInvalidValue;
  const int kk = (int)k;
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro_torch::kF32 && r_dtype == repro_torch::kF32)
    return (int)launch_k<float, float>(op, X, G, R, out, r, kk, eps, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kF32)
    return (int)launch_k<bf16, float>(op, X, G, R, out, r, kk, eps, s);
  if (x_dtype == repro_torch::kBF16 && r_dtype == repro_torch::kBF16)
    return (int)launch_k<bf16, bf16>(op, X, G, R, out, r, kk, eps, s);
  return (int)cudaErrorInvalidValue;
}
