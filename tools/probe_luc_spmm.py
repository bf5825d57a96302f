#!/usr/bin/env python3
"""Probe the floors, tiles and accuracy of spmm_sorted, mu_update and
hals_sweep on one NVIDIA GPU, at the paths' full sizes.

    python3 tools/probe_luc_spmm.py [--parts spmm mu hals] [--old-luc PATH]

It prints, with the card's name and power limit:

* spmm: the gather floor, a kernel that walks the sorted layout of A (A·B
  and Aᵀ·C) exactly as ``spmm_sorted_kernel`` does and gathers the same B
  rows into registers, but adds them into one register and stores
  nothing, timed in turns with ``spmm_sorted``;
* mu: ``mu_update`` at each (rows, k) of ``--rows`` × ``--mu-k`` in fp32
  and with a bf16 carry: the default plan and the plain version in turns;
  then other (rows, stages, blocks per SM) tiles of ``MU_TILES``, an fp32
  X read in place and widened alike, each checked against the default
  plan's bits and timed in turns with it;
* hals: ``hals_sweep`` at each (rows, k) of ``--hals-shapes`` in fp32 (and
  with a bf16 carry at k = 50) on chip_smoke.py's problem: the default
  plan, the plain version and, with ``--old-luc`` (an older luc.cu with
  the same ``luc_launch`` interface, whose op 1 ignores the plan), that
  kernel, in turns; each held against float64 sums on the scale of what a
  column's update adds and cancels (ref.sweep_scaled_err); then every
  other tile (rows
  of ``ops.HALS_ROWS``, stages, a thread a row or four, G whole and
  restaged) that fits, each checked against the default plan's bits and
  timed in turns with it.

Times are CUDA-event means after a warm-up.  Everything is made on the
device from a seed.  The result is also written to build/probe/probe.json.
Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
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
# (rows, k) of hals_sweep: the sparse path's factor and Video's W at the
# main width, and Video's W at the wide phase's k
HALS_SHAPES = ((1 << 24, K), (VIDEO_M, K), (VIDEO_M, K_WIDE))

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
    """nvcc of the probe kernels and of an older luc.cu, in parallel;
    returns name -> loaded library."""
    from repro_torch.kernels import build
    csrc = str(build.CSRC)
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, src in (("gather", GATHER_SRC),):
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
        else:
            lib.luc_launch.argtypes = build.SIGNATURES["luc"]["luc_launch"]
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


def probe_mu(rows_list, ks, seed: int) -> dict:
    import chip_smoke
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
                    f"column-scaled err vs plain {plain_err:.2e}")
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


def hals_tiles(r: int, k: int, size: int, sms: int):
    """Every HalsPlan of ops.HALS_ROWS × HALS_STAGES, a thread a row and
    HALS_WIDE_TPR, that fits, G whole and restaged, with as many blocks an
    SM as fit."""
    from repro_torch.kernels import ops
    direct = size == 4 and math.gcd(k, 32) <= 2
    nb = -(-k // ops.HALS_BLOCK)
    plans = []
    for rows in ops.HALS_ROWS:
        for tpr in (1, ops.HALS_WIDE_TPR):
            if rows * tpr > ops.HALS_MAX_THREADS:
                continue
            for stages in ops.HALS_STAGES:
                for gblocks in dict.fromkeys((nb, 1)):
                    smem = ops.hals_smem(k, rows, stages, gblocks, size, 4,
                                         direct)
                    per_sm = ops._hals_blocks_per_sm(smem, rows * tpr)
                    if smem <= ops.SMEM_PER_BLOCK and per_sm >= 1:
                        plans.append(ops.HalsPlan(
                            rows, stages, gblocks, tpr,
                            min(-(-r // rows), per_sm * sms), smem, direct))
    return plans


def probe_hals(shapes, seed: int, libs: dict) -> dict:
    import chip_smoke
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    old = libs.get("old_luc")
    out = {}
    for r, k in shapes:
        for dt in ((torch.float32, torch.bfloat16) if k == K
                   else (torch.float32,)):
            X, G, R = chip_smoke.luc_problem(gen, r, k, dt, torch.float32)
            eps = eps_for(dt)
            size = X.element_size()
            nbytes = r * k * (2 * size + 4)
            default = ops.plan_hals_sweep(r, k, size, sms)
            want = ops.hals_sweep(X, G, R, eps=eps)
            plain = ref.hals_sweep(X, G, R, eps)
            exact = ref.hals_sweep_f64(X, G, R, eps)
            errs = {"vs_plain": ref.sweep_scaled_err(
                        want, plain, X, G, R, eps),
                    "vs_f64": ref.sweep_scaled_err(
                        want, exact, X, G, R, eps),
                    "plain_vs_f64": ref.sweep_scaled_err(
                        plain, exact, X, G, R, eps)}
            del plain, exact

            def call(plan):
                return lambda: ops.hals_sweep(X, G, R, eps=eps, plan=plan)
            turns = [("kernel", call(default)),
                     ("plain", lambda: ref.hals_sweep(X, G, R, eps))]
            if old is not None:
                o = torch.empty_like(X)
                scratch = torch.empty((k, k), device=dev)
                codes = (0 if dt == torch.float32 else 1, 0)
                blocks = ops._rowwise_blocks(r, sms)

                def old_call():
                    rc = old.luc_launch(1, *codes, X.data_ptr(),
                                        G.data_ptr(), R.data_ptr(),
                                        o.data_ptr(), scratch.data_ptr(), r,
                                        k, eps, 0, 0, 0, 0, blocks, 0, 0,
                                        stream)
                    assert rc == 0, rc
                    return o
                errs["old_vs_kernel"] = ref.sweep_scaled_err(
                    old_call(), want, X, G, R, eps)
                turns.insert(1, ("old kernel", old_call))
            reps = 10 if r * k * k < 1e10 else 3
            ms = {name: [] for name, _ in turns}
            for order in (turns, turns[::-1]):
                for name, fn in order:
                    ms[name].append(time_ms(fn, 2 if name == "plain"
                                            else reps))
            res = {name: min(t) for name, t in ms.items()}
            res.update(errs)
            tag = f"{r}/{k}/{str(dt)[6:]}"
            text = ", ".join(f"{name} {t[0]:.3f}/{t[1]:.3f} ms"
                             for name, t in ms.items())
            log(f"[hals] {tag}: plan {default.rows} rows x {default.tpr} "
                f"threads x {default.stages} stages, gblocks "
                f"{default.gblocks}, "
                f"{default.blocks} blocks, direct {default.direct}: {text} "
                f"({nbytes / (res['kernel'] * 1e-3) / 1e9:.0f} GB/s); "
                f"sweep-scaled: kernel vs plain {errs['vs_plain']:.2e}, vs "
                f"float64 {errs['vs_f64']:.2e}, plain vs float64 "
                f"{errs['plain_vs_f64']:.2e}"
                + (f", old kernel vs kernel {errs['old_vs_kernel']:.2e}"
                   if old is not None else ""))
            for plan in hals_tiles(r, k, size, sms):
                if plan == default:
                    continue
                same = torch.equal(call(plan)(), want)
                d1, p1, p2, d2 = (time_ms(f, reps) for f in (
                    call(default), call(plan), call(plan), call(default)))
                name = (f"{plan.rows}t{plan.tpr}x{plan.stages}g{plan.gblocks}"
                        f"b{plan.blocks}")
                res[name] = min(p1, p2)
                log(f"[hals] {tag}: tile {plan.rows} rows x {plan.tpr} "
                    f"threads x {plan.stages} stages, gblocks "
                    f"{plan.gblocks}, "
                    f"{plan.blocks} blocks, {plan.smem} B: {p1:.3f}/{p2:.3f}"
                    f" ms against the default's {d1:.3f}/{d2:.3f}; same bits "
                    f"{same}")
            out[tag] = res
            del X, G, R, want
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
    ap.add_argument("--hals-shapes", type=int, nargs="*",
                    default=[x for s in HALS_SHAPES for x in s],
                    help="rows and k of each shape, flat: r1 k1 r2 k2 ...")
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
        result["mu"] = probe_mu(args.rows, args.mu_k, args.seed)
    if "hals" in args.parts:
        shapes = list(zip(args.hals_shapes[::2], args.hals_shapes[1::2]))
        result["hals"] = probe_hals(shapes, args.seed, libs)
    if "spmm" in args.parts:
        result["spmm_sorted"] = probe_spmm(args.sparse_dim, args.seed, libs)
    with open(os.path.join(out_dir, "probe.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
