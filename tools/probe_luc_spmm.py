#!/usr/bin/env python3
"""Probe the floors, tiles and accuracy of spmm_sorted, mu_update and the
wide hals_sweep on one NVIDIA GPU, at the paths' full sizes.

    python3 tools/probe_luc_spmm.py [--parts spmm mu hals] [--old-luc PATH]

It prints, with the card's name and power limit:

* spmm: the gather floor, a kernel that walks the sorted layout of A (A·B
  and Aᵀ·C) exactly as ``spmm_sorted_kernel`` does and gathers the same B
  rows into registers, but adds them into one register and stores
  nothing, timed in turns with ``spmm_sorted``;
* mu: ``mu_update`` at each (rows, k) of ``--rows`` × ``--mu-k`` in fp32
  and with a bf16 carry: the default plan, the plain version and, with
  ``--old-luc`` (a luc.cu with the one-plan interface ``luc_launch(op,
  x_dtype, r_dtype, X, G, R, out, r, k, eps, stream)``), that kernel, in
  turns; then other (rows, stages, blocks per SM) tiles of ``MU_TILES``,
  an fp32 X read in place and widened alike, each checked against the
  default plan's bits and timed in turns with it;
* hals: ``hals_sweep`` at (``--hals-rows``, 160) in fp32 for each seed of
  ``--seeds`` on chip_smoke.py's problem, the kernel, its plain version
  and copies of the kernel that sum X·G_i in other orders, each against
  float64: per column, the error over the column's maximum and over the
  size of what the column's update adds and cancels
  (chip_smoke.sweep_scaled_err).

Times are CUDA-event means after a warm-up.  Everything is made on the
device from a seed.  The result is also written to build/probe/probe.json.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

K = 50
K_WIDE = 160
WEBBASE_ROWS, WEBBASE_NNZ = 118_142_155, 1_019_903_190
VIDEO_M = 1_013_400
HBM_BYTES_PER_S = 3.35e12
# (rows, stages, blocks per SM) of mu_update, G whole
MU_TILES = ((128, 2, 2), (64, 3, 2), (64, 2, 2), (64, 2, 3), (32, 3, 2),
            (32, 2, 3), (32, 3, 4), (64, 2, 1), (32, 3, 1), (32, 2, 1),
            (16, 3, 1))
# the sums of hals_order_kernel: 0 as the library's kernel (lane-strided
# partials and a butterfly), 1 serial in order, 2 contiguous lane
# partials and a butterfly, 3 the library's order in float64
HALS_ORDERS = {"lane-strided": 0, "serial": 1, "lane-blocked": 2,
               "float64 sums": 3}

GATHER_SRC = r'''
#include "spmm.cu"
namespace {
// spmm_sorted_kernel's walk and gathers, without the products' stores.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
gather_probe_kernel(const int* __restrict__ cols,
                    const int* __restrict__ first_unit,
                    const int* __restrict__ valid, const T* __restrict__ B,
                    float* __restrict__ sink, int64_t ntiles, int64_t k,
                    int64_t align) {
  const int lane = threadIdx.x & 31;
  const int64_t t = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (t >= ntiles) return;
  const int64_t col = (int64_t)blockIdx.y * SPANEL + (VEC == 2 ? 2 * lane : lane);
  float acc = 0.f;
  for (int64_t u = first_unit[t]; u < first_unit[t + 1]; ++u) {
    const int nv = valid[u];
    for (int s0 = 0; s0 < nv; s0 += 32) {
      const int c = s0 + lane < nv ? cols[u * align + s0 + lane] : 0;
      const int run = nv - s0 < 32 ? nv - s0 : 32;
      for (int j0 = 0; j0 < run; j0 += SORTED_GATHER) {
        float2 bj[SORTED_GATHER];
#pragma unroll
        for (int q = 0; q < SORTED_GATHER; ++q) {
          const int cj = __shfl_sync(FULL, c, j0 + q < run ? j0 + q : 0);
          bj[q] = j0 + q < run ? load_pair<VEC>(B + (int64_t)cj * k, col, k)
                               : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < SORTED_GATHER; ++q) acc += bj[q].x + bj[q].y;
      }
    }
  }
  if (acc == 1234567.f) sink[0] = acc;     // keeps the loads alive
}
}  // namespace
extern "C" int gather_probe_launch(const void* cols, const void* first,
                                   const void* valid, const void* B,
                                   void* sink, int64_t ntiles, int64_t k,
                                   int64_t align, void* stream) {
  const dim3 grid((unsigned)((ntiles + WARPS - 1) / WARPS),
                  (unsigned)((k + SPANEL - 1) / SPANEL));
  gather_probe_kernel<float, 2><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const int*)first, (const int*)valid,
      (const float*)B, (float*)sink, ntiles, k, align);
  return (int)cudaGetLastError();
}
'''

HALS_SRC = r'''
#include "luc.cu"
namespace {
// hals_rowwise_kernel (fp32) with X·G_i summed in the order ORDER: 0 as
// the library's kernel, 1 serially in order by every lane, 2 lane j over
// the contiguous columns [j·c, (j+1)·c), c = ceil(k / 32), then the same
// butterfly, 3 the library's order in float64 with the update in float64
// (only the stored x_i rounded to fp32).
template <int ORDER>
__global__ void __launch_bounds__(WIDE_THREADS)
hals_order_kernel(const float* __restrict__ X, const float* __restrict__ Gt,
                  const float* __restrict__ R, float* out, int64_t r,
                  int64_t k, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (WIDE_THREADS / 32);
  for (int64_t t = (int64_t)blockIdx.x * (WIDE_THREADS / 32) +
                   (threadIdx.x >> 5);
       t < r; t += warps) {
    float* o = out + t * k;
    for (int64_t l = lane; l < k; l += 32) o[l] = X[t * k + l];
    __syncwarp();
    for (int64_t i = 0; i < k; ++i) {
      const float* gi = Gt + i * k;
      double d = 0.0;
      float s = 0.f;
      if (ORDER == 1) {
        for (int64_t l = 0; l < k; ++l) s = fmaf(o[l], gi[l], s);
      } else if (ORDER == 3) {
        for (int64_t l = lane; l < k; l += 32)
          d = fma((double)o[l], (double)gi[l], d);
        for (int off = 16; off > 0; off /= 2)
          d += __shfl_xor_sync(FULL, d, off);
      } else {
        const int64_t c = (k + 31) / 32;
        const int64_t l0 = ORDER == 2 ? lane * c : lane;
        const int64_t l1 = ORDER == 2 ? (l0 + c < k ? l0 + c : k) : k;
        for (int64_t l = l0; l < l1; l += ORDER == 2 ? 1 : 32)
          s = fmaf(o[l], gi[l], s);
        for (int off = 16; off > 0; off /= 2)
          s += __shfl_xor_sync(FULL, s, off);
      }
      if (lane == (int)(i & 31)) {
        float gii = gi[i];
        gii = gii < eps ? eps : gii;
        float v;
        if (ORDER == 3)
          v = (float)((double)o[i] + ((double)R[t * k + i] - d) / gii);
        else
          v = o[i] + (R[t * k + i] - s) / gii;
        o[i] = v < 0.f ? 0.f : v;
      }
      __syncwarp();
    }
  }
}
}  // namespace
extern "C" int hals_order_launch(int order, const void* X, const void* Gt,
                                 const void* R, void* out, int64_t r,
                                 int64_t k, float eps, int blocks,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)X;
  const float* g = (const float*)Gt;
  const float* rr = (const float*)R;
  float* o = (float*)out;
  if (order == 0)
    hals_order_kernel<0><<<blocks, WIDE_THREADS, 0, s>>>(x, g, rr, o, r, k, eps);
  else if (order == 1)
    hals_order_kernel<1><<<blocks, WIDE_THREADS, 0, s>>>(x, g, rr, o, r, k, eps);
  else if (order == 2)
    hals_order_kernel<2><<<blocks, WIDE_THREADS, 0, s>>>(x, g, rr, o, r, k, eps);
  else
    hals_order_kernel<3><<<blocks, WIDE_THREADS, 0, s>>>(x, g, rr, o, r, k, eps);
  return (int)cudaGetLastError();
}
'''


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_probes(out_dir: str, old_luc: str | None) -> dict:
    """nvcc of the probe kernels (and of an older luc.cu), in parallel;
    returns name -> loaded library."""
    from repro_torch.kernels import build
    csrc = str(build.CSRC)
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, src in (("gather", GATHER_SRC), ("hals", HALS_SRC)):
        path = os.path.join(out_dir, f"{name}_probe.cu")
        with open(path, "w") as f:
            f.write(src)
        jobs[name] = path
    if old_luc:
        jobs["old_luc"] = os.path.abspath(old_luc)
    procs = {}
    for name, src in jobs.items():
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", so,
               src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, I64, I, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, \
        ctypes.c_float
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{text}")
        lib = ctypes.CDLL(so)
        if name == "gather":
            lib.gather_probe_launch.argtypes = [P, P, P, P, P, I64, I64, I64,
                                                P]
        elif name == "hals":
            lib.hals_order_launch.argtypes = [I, P, P, P, P, I64, I64, F, I,
                                              P]
        else:
            lib.luc_launch.argtypes = [I, I, I, P, P, P, P, I64, I64, F, P]
        libs[name] = lib
    return libs


def probe_spmm(dim: int, seed: int, libs: dict) -> dict:
    import torch
    from repro_torch.core import blocksparse
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    density = WEBBASE_NNZ / WEBBASE_ROWS / dim
    blk = blocksparse.blockify(erdos_renyi_bcoo(gen, dim, dim, density), 1, 1)
    srt = blk.sort_rows()
    nnz = blk.nnz
    del blk
    torch.cuda.empty_cache()
    B = torch.rand((dim, K), generator=gen, device=dev)
    sink = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ntiles = -(-dim // 8)
    gather_gb = nnz * K * 4 / 1e9
    compulsory = (nnz * 12 + 2 * dim * K * 4) / 1e9
    log(f"[spmm] {dim} x {dim}, nnz {nnz}: gathers {gather_gb:.2f} GB "
        f"({gather_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at 3.35 TB/s), "
        f"compulsory {compulsory:.2f} GB")
    out = {}
    for prod, leaves in (("A·B", ("vals", "rows", "cols", "row_tiles",
                                  "row_valid", "row_first")),
                         ("Aᵀ·C", ("t_vals", "t_rows", "t_cols", "col_tiles",
                                   "col_valid", "col_first"))):
        v, r, c, tl, vd, first = (getattr(srt, f).reshape(-1)
                                  for f in leaves)

        def probe():
            rc = libs["gather"].gather_probe_launch(
                c.data_ptr(), first.data_ptr(), vd.data_ptr(), B.data_ptr(),
                sink.data_ptr(), ntiles, K, srt.align, stream)
            assert rc == 0, rc

        def kernel():
            return ops.spmm_sorted(v, r, c, tl, vd, B, dim, align=srt.align,
                                   first=first)

        p1, l1, l2, p2 = (time_ms(f, 5) for f in (probe, kernel, kernel,
                                                   probe))
        out[prod] = {"gather_floor_ms": min(p1, p2), "ms": min(l1, l2)}
        log(f"[spmm] {prod}: gather floor {p1:.3f}/{p2:.3f} ms "
            f"({gather_gb / (min(p1, p2) * 1e-3):.0f} GB/s of gathers); "
            f"spmm_sorted {l1:.3f}/{l2:.3f} ms")
    return out


def mu_tile(r: int, k: int, size: int, sms: int, rows: int, stages: int,
            per_sm: int, direct: bool):
    """A MuPlan of a pinned tile with G whole, or None if it does not fit
    ``per_sm`` blocks on an SM."""
    from repro_torch.kernels import ops
    smem = ops.mu_smem(k, rows, stages, k, size, 4, direct)
    if per_sm * (smem + ops.SMEM_RESERVED_PER_BLOCK) > ops.SMEM_PER_SM:
        return None
    return ops.MuPlan(rows, stages, k, max(1, min(8, rows // 16)),
                      min(-(-r // rows), per_sm * sms), smem, direct)


def probe_mu(rows_list, ks, seed: int, libs: dict) -> dict:
    import chip_smoke
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    old = libs.get("old_luc")
    out = {}
    for r in rows_list:
        for k in ks:
            for dt in (torch.float32, torch.bfloat16):
                X, G, R = chip_smoke.luc_problem(gen, r, k, dt,
                                                 torch.float32)
                eps = eps_for(dt)
                size = X.element_size()
                nbytes = r * k * (2 * size + 4)
                default = ops.plan_mu_update(r, k, size, sms)
                want = ops.mu_update(X, G, R, eps=eps)
                plain_err = chip_smoke.col_scaled_err(
                    want, ref.mu_update(X, G, R, eps))[1]

                def call(plan):
                    return lambda: ops.mu_update(X, G, R, eps=eps, plan=plan)

                def plain():
                    return ref.mu_update(X, G, R, eps)
                turns = [("kernel", call(default)), ("plain", plain)]
                if old is not None and k <= 128:
                    o = torch.empty_like(X)
                    codes = (0 if dt == torch.float32 else 1, 0)

                    def old_call():
                        rc = old.luc_launch(0, *codes, X.data_ptr(),
                                            G.data_ptr(), R.data_ptr(),
                                            o.data_ptr(), r, k, eps, stream)
                        assert rc == 0, rc
                        return o
                    old_err = chip_smoke.col_scaled_err(old_call(), want)[1]
                    turns.insert(1, ("old kernel", old_call))
                ms = {name: [] for name, _ in turns}
                for order in (turns, turns[::-1]):
                    for name, fn in order:
                        ms[name].append(time_ms(fn, 10))
                res = {name: min(t) for name, t in ms.items()}
                tag = f"{r}/{k}/{str(dt)[6:]}"
                text = ", ".join(f"{name} {t[0]:.3f}/{t[1]:.3f} ms"
                                 for name, t in ms.items())
                log(f"[mu] {tag}: plan {default.rows}x{default.stages} "
                    f"stages, {default.blocks} blocks, direct "
                    f"{default.direct}: {text} "
                    f"({nbytes / (res['kernel'] * 1e-3) / 1e9:.0f} GB/s); "
                    f"column-scaled err vs plain {plain_err:.2e}"
                    + (f", old kernel vs kernel {old_err:.2e}"
                       if "old kernel" in ms else ""))
                for t, s, per_sm in MU_TILES:
                    for direct in ((False, True) if size == 4 else (False,)):
                        plan = mu_tile(r, k, size, sms, t, s, per_sm, direct)
                        if plan is None:
                            continue
                        same = torch.equal(call(plan)(), want)
                        d1, p1, p2, d2 = (time_ms(f, 10) for f in (
                            call(default), call(plan), call(plan),
                            call(default)))
                        name = f"{t}x{s}x{per_sm}{'d' if direct else ''}"
                        res[name] = min(p1, p2)
                        log(f"[mu] {tag}: tile {t} rows x {s} stages x "
                            f"{per_sm} per SM, direct {direct}, "
                            f"{plan.smem} B: {p1:.3f}/{p2:.3f} ms against "
                            f"the default's {d1:.3f}/{d2:.3f}; same bits "
                            f"{same}")
                out[tag] = res
                del X, G, R, want
                torch.cuda.empty_cache()
    return out


def probe_hals(r: int, seeds, libs: dict) -> dict:
    import chip_smoke
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    k = K_WIDE
    eps = eps_for(torch.float32)
    blocks = ops._rowwise_blocks(
        r, torch.cuda.get_device_properties(dev).multi_processor_count)
    out = {}
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        X, G, R = chip_smoke.luc_problem(gen, r, k, torch.float32,
                                         torch.float32)
        Gt = G.T.contiguous()
        exact = chip_smoke.luc_f64("hals_sweep", X, G, R, eps)
        outs = {"kernel": ops.hals_sweep(X, G, R, eps=eps),
                "plain": ref.hals_sweep(X, G, R, eps)}
        for name, order in HALS_ORDERS.items():
            o = torch.empty_like(X)
            rc = libs["hals"].hals_order_launch(
                order, X.data_ptr(), Gt.data_ptr(), R.data_ptr(),
                o.data_ptr(), r, k, eps, blocks, stream)
            assert rc == 0, rc
            outs[name] = o
        same = torch.equal(outs["kernel"], outs["lane-strided"])
        res = {}
        for name, got in outs.items():
            col = chip_smoke.col_scaled_err(got.double(), exact)[1]
            sweep = chip_smoke.sweep_scaled_err(got, exact, X, G, R, eps)
            diff = (got.double() - exact).abs()
            res[name] = {"column_scaled": col, "sweep_scaled": sweep,
                         "abs": diff.max().item(),
                         "rms_abs": diff.square().mean().sqrt().item(),
                         "worst_column": int(diff.amax(0).argmax())}
            log(f"[hals] seed {seed} {name:13s} vs float64: column-scaled "
                f"{col:.3e}, sweep-scaled {sweep:.3e}, abs max "
                f"{res[name]['abs']:.3e} rms {res[name]['rms_abs']:.3e}, "
                f"worst column {res[name]['worst_column']}")
        kp = chip_smoke.sweep_scaled_err(outs["kernel"], outs["plain"], X, G,
                                         R, eps)
        res["kernel_vs_plain_sweep_scaled"] = kp
        log(f"[hals] seed {seed}: kernel vs plain sweep-scaled {kp:.3e}; "
            f"the lane-strided copy gives the kernel's bits: {same}")
        out[str(seed)] = res
        del X, G, R, Gt, exact, outs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", nargs="*", default=["spmm", "mu", "hals"],
                    choices=["spmm", "mu", "hals"])
    ap.add_argument("--sparse-dim", type=int, default=1 << 24)
    ap.add_argument("--rows", type=int, nargs="*",
                    default=[1 << 24, VIDEO_M])
    ap.add_argument("--mu-k", type=int, nargs="*", default=[K])
    ap.add_argument("--old-luc", default=None)
    ap.add_argument("--hals-rows", type=int, default=VIDEO_M)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    log(f"[card] {card}")
    t0 = time.perf_counter()
    from repro_torch.kernels import build
    build.build()
    out_dir = os.path.join(ROOT, "build", "probe")
    libs = build_probes(out_dir, args.old_luc)
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    result = {"card": card}
    if "mu" in args.parts:
        result["mu"] = probe_mu(args.rows, args.mu_k, args.seed, libs)
    if "hals" in args.parts:
        result["hals"] = probe_hals(args.hals_rows, args.seeds, libs)
    if "spmm" in args.parts:
        result["spmm_sorted"] = probe_spmm(args.sparse_dim, args.seed, libs)
    with open(os.path.join(out_dir, "probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
