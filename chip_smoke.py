#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # from the root of a checkout

The main path is the paper's serial loop, ``NMFSolver(k, algo=...).fit(A)``
on a dense fp32 A at the paper's Video shape (m = 1,013,400, n = 13,824,
k = 50; A is 56.04 GB), made on the device from ``--seed`` as low rank plus
noise.  Phases, each of which raises on failure:

  1. card      nvidia-smi's name and power limit;
  2. build     nvcc builds every kernel of the path from csrc/, in parallel;
  3. data      A on the device;
  4. kernels   each kernel against its plain PyTorch version (kernels/ref.py)
               in fp32 and bf16, at the path's widths on a 65,536-row slice
               of A and at ragged shapes;
  5. small     the whole path on the card against the CPU path at 96×64;
  6. timings   each kernel at the full shape in fp32 against its plain
               version, then timed with CUDA events beside its bound, its
               plain version and one torch.matmul call;
  7. main      fit() at the full shape: bpp for 10 iterations, then mu and
               hals for 3 each, with the launch counters reset just before
               each fit and read just after; the last rel error is checked
               against a direct ||A − WH|| / ||A||;
  8. breakdown ms per iteration in each product and half-update (CUDA
               events around the backend's and the rule's calls).

Before the last line it prints the kernels as one JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

M_FULL, N_FULL, K = 1_013_400, 13_824, 50     # benchmarks/bench_datasets.py:19
CHECK_ROWS = 65_536
RAGGED = (4_099, 1_001, 70)                   # every axis ragged, k > 64
NOISE = 0.5
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # scaled atol of test_kernels.py

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, HBM3.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

KERNELS = {
    "gram": {"source": "src/repro_torch/kernels/csrc/gram.cu",
             "replaces": "src/repro/kernels/gram.py:42"},
    "ts_matmul": {"source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
                  "replaces": "src/repro/kernels/ts_matmul.py:44"},
    "ts_matmul_t": {"source": "src/repro_torch/kernels/csrc/ts_matmul.cu",
                    "replaces": "src/repro/kernels/ts_matmul.py:76"},
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def scaled_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max |want|)."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / (want.float().abs().max().item() + 1e-9)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
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


def bound_ms(read_bytes: int, write_bytes: int, flops: float,
             dtype: str) -> tuple[float, str]:
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[card] {out}")
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name in paths:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(A, Ht, W, errs: dict) -> None:
    """Each kernel against its plain version, fp32 and bf16, at the path's
    widths on a 65,536-row slice and at a ragged shape."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=A.device).manual_seed(1)
    m, n, k = RAGGED
    ragged = [torch.rand(s, generator=gen, device=A.device)
              for s in ((m, n), (n, k), (m, k))]
    cases = {"slice": (A[:CHECK_ROWS], Ht, W[:CHECK_ROWS]),
             "ragged": tuple(ragged)}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).removeprefix("torch.")
        for case, (a, b, w) in cases.items():
            a, b, w = a.to(dt), b.to(dt), w.to(dt)
            for name, got, want in (
                    ("ts_matmul", ops.ts_matmul(a, b), ref.ts_matmul(a, b)),
                    ("ts_matmul_t", ops.ts_matmul_t(a, w),
                     ref.ts_matmul_t(a, w)),
                    ("gram", ops.gram(w), ref.gram(w)),
                    ("gram", ops.gram(b), ref.gram(b))):
                torch.cuda.synchronize()
                abs_err, err = scaled_err(got, want)
                ok = err <= TOL[dname]
                log(f"[kernels] {name:12s} {dname:8s} {case:6s} "
                    f"{tuple(a.shape) if name != 'gram' else tuple(got.shape)}"
                    f" scaled err {err:.3e} (tol {TOL[dname]:.0e}) "
                    f"abs {abs_err:.3e} {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} {dname} {case} disagrees with its plain "
                            f"version: {err:.3e} > {TOL[dname]}")
                e = errs.setdefault(name, [0.0, 0.0])
                e[0], e[1] = max(e[0], abs_err), max(e[1], err)
            del a, b, w
    torch.cuda.empty_cache()


def phase_small() -> None:
    """The whole path on the card against the CPU path (plain versions),
    at the parity tests' size."""
    import numpy as np
    from repro_torch.core.engine import NMFSolver
    rng = np.random.default_rng(9)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + NOISE * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    for algo in ("mu", "hals", "bpp"):
        gpu = NMFSolver(k, algo=algo, max_iters=3).fit(A, W0=W0, H0=H0)
        cpu = NMFSolver(k, algo=algo, device="cpu", max_iters=3).fit(
            A, W0=W0, H0=H0)
        r_g, r_c = gpu.rel_errors.numpy(), cpu.rel_errors.numpy()
        w_err = (np.abs(gpu.W.cpu().numpy() - cpu.W.numpy()).max()
                 / np.abs(cpu.W.numpy()).max())
        log(f"[small] {algo:4s} rel errors card {r_g} cpu {r_c}; "
            f"W scaled err {w_err:.2e}")
        require(np.allclose(r_g, r_c, rtol=1e-4, atol=0) and w_err <= 1e-4,
                f"{algo} on the card disagrees with the CPU path")


def phase_timings(A, Ht, W, errs: dict) -> dict:
    """Each kernel at the full shape: held against its plain version there
    (the slab plan and 64-bit offsets of A differ from the slice's), then
    timed beside its bound, its plain version and one torch.matmul call."""
    import torch
    from repro_torch.kernels import ops, ref
    m, n = A.shape
    k = Ht.shape[1]
    f4 = 4
    # XᵀX is symmetric: its k·(k+1)/2 distinct entries need r multiply-adds each
    plans = {
        "ts_matmul": (lambda: ops.ts_matmul(A, Ht),
                      lambda: ref.ts_matmul(A, Ht),
                      lambda: torch.matmul(A, Ht),
                      (m * n + n * k) * f4, m * k * f4, 2.0 * m * n * k, 3),
        "ts_matmul_t": (lambda: ops.ts_matmul_t(A, W),
                        lambda: ref.ts_matmul_t(A, W),
                        lambda: torch.matmul(A.T, W),
                        (m * n + m * k) * f4, n * k * f4, 2.0 * m * n * k, 3),
        "gram": (lambda: ops.gram(W), lambda: ref.gram(W),
                 lambda: torch.matmul(W.T, W),
                 m * k * f4, k * k * f4, 1.0 * m * k * (k + 1), 20),
    }
    for name, (kern, plain, *_) in plans.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, err = scaled_err(got, want)
        ok = err <= TOL["float32"]
        log(f"[kernels] {name:12s} float32  full   "
            f"{tuple(A.shape) if name != 'gram' else tuple(got.shape)} scaled "
            f"err {err:.3e} (tol {TOL['float32']:.0e}) abs {abs_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} float32 at the full shape disagrees with its "
                    f"plain version: {err:.3e} > {TOL['float32']}")
        e = errs.setdefault(name, [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        del got, want
    out = {}
    for name, (kern, plain, lib, rb, wb, flops, reps) in plans.items():
        # in turns: plain, kernel, kernel, plain (then the library call)
        p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kern, kern, plain))
        lib_ms = time_ms(lib, reps)
        b_ms, b_by = bound_ms(rb, wb, flops, "float32")
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        log(f"[timings] {name:12s} fp32 kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}); {flops / (min(k1, k2) * 1e-3) / 1e12:.1f}"
            f" TFLOP/s, {(rb + wb) / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    g_ht = time_ms(lambda: ops.gram(Ht), 50)
    b_ht, by_ht = bound_ms(n * k * f4, k * k * f4, 1.0 * n * k * (k + 1),
                           "float32")
    log(f"[timings] gram(Ht)     fp32 kernel {g_ht:.4f} ms at {(n, k)}, bound "
        f"{b_ht:.4f} ms ({by_ht})")
    return out


def phase_main(A, seed: int, runs) -> tuple[dict, dict]:
    import numpy as np
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = A.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    for algo, iters in runs:
        solver = NMFSolver(K, algo=algo, max_iters=iters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        rels = res.rel_errors.numpy()
        log(f"[main] {algo:4s} {iters} iters at {(m, n, K)}: fit {wall:.2f} s "
            f"incl. set-up, {wall / iters:.3f} s/iter, peak memory "
            f"{peak:.2f} GB, launches {counts}")
        log(f"[main] {algo:4s} rel errors {rels.tolist()}")
        want = {"gram": 3 * iters, "ts_matmul": iters, "ts_matmul_t": iters}
        require(counts == want, f"{algo}: launches {counts} != {want}")
        require(rels.shape == (iters,) and np.isfinite(rels).all(),
                f"{algo}: rel errors not finite: {rels}")
        require(tuple(res.W.shape) == (m, K) and tuple(res.H.shape) == (K, n),
                f"{algo}: factor shapes {res.W.shape} {res.H.shape}")
        require(bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
                     and res.W.min() >= 0 and res.H.min() >= 0),
                f"{algo}: factors not finite and nonnegative")
        if algo == "mu":
            require(bool(np.all(np.diff(rels) <= 0)),
                    f"mu rel errors increase: {rels}")
        direct = direct_rel_error(A, res.W, res.H)
        log(f"[main] {algo:4s} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        # the trace trick loses digits to cancellation near the noise floor
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{algo}: rel error {rels[-1]} disagrees with the direct "
                f"value {direct}")
        for name in launches:
            launches[name] += counts[name]
        summary[algo] = {"iters": iters, "s_per_iter": wall / iters,
                         "peak_gb": peak, "rel_errors": rels.tolist()}
        del res
        torch.cuda.empty_cache()
    return launches, summary


def phase_breakdown(A, seed: int, runs) -> dict:
    """Where an iteration's time goes: CUDA events around each local
    product and each half-update of a few fixed iterations (the step is the
    engine's own; only the backend and the rule are wrapped).  "other" is
    the host-clock wall time minus the spans: the error from byproducts,
    casts and the host loop.  The set-up of a fit (factor init and ||A||²,
    one pass over A) is timed on its own."""
    import torch
    from repro_torch.backends import CudaOps
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
    m = A.shape[0]
    spans = []

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            label = name(*args) if callable(name) else name
            spans.append((label, start, end))
            return out
        return run

    class TimedOps(CudaOps):
        mm = timed("ts_matmul", CudaOps.mm)
        mm_t = timed("ts_matmul_t", CudaOps.mm_t)
        gram = timed(lambda self, X: "gram(W)" if X.shape[0] == m
                     else "gram(Ht)", CudaOps.gram)

    out = {}
    for algo, iters in runs:
        rule = rules.get_rule(algo)
        rule.update_w = timed("update_w", rule.update_w)
        rule.update_h = timed("update_h", rule.update_h)
        solver = NMFSolver(K, algo=rule, backend=TimedOps(), max_iters=iters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = solver.prepare_state(A, seed=seed)
        torch.cuda.synchronize()
        prepare_ms = (time.perf_counter() - t0) * 1e3
        spans.clear()
        t0 = time.perf_counter()
        solver.run_segment(rs, iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        per = {}
        for label, start, end in spans:
            per[label] = per.get(label, 0.0) + start.elapsed_time(end) / iters
        per["other"] = wall_ms - sum(per.values())
        per["wall"] = wall_ms
        per["prepare (once per fit)"] = prepare_ms
        out[algo] = per
        log(f"[breakdown] {algo:4s} ms/iter over {iters} iters: "
            + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
        del rs
        torch.cuda.empty_cache()
    return out


def direct_rel_error(A, W, H, rows: int = 32_768) -> float:
    """||A − WH||_F / ||A||_F without the trace trick, in row chunks (a
    check only: torch.matmul, fp64 sums)."""
    import torch
    num = torch.zeros((), dtype=torch.float64, device=A.device)
    den = torch.zeros((), dtype=torch.float64, device=A.device)
    for r0 in range(0, A.shape[0], rows):
        blk = A[r0:r0 + rows]
        diff = blk - W[r0:r0 + rows] @ H
        num += (diff * diff).sum(dtype=torch.float64)
        den += (blk * blk).sum(dtype=torch.float64)
    return float((num / den).sqrt())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=M_FULL,
                    help="rows of A; cut only if the time limit forces it")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.data.pipeline import lowrank_matrix
    torch.backends.cuda.matmul.allow_tf32 = False   # exact fp32 references
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = phase_card()
    phase_build()

    dev = torch.device("cuda", 0)
    m, n = args.m, N_FULL
    if m != M_FULL:
        log(f"[data] cut: m = {m} of the Video shape's {M_FULL}")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A = lowrank_matrix(gen, m, n, K, noise=NOISE)
    Ht = torch.rand((n, K), generator=gen, device=dev)
    W = torch.rand((m, K), generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"[data] A {tuple(A.shape)} fp32 = {A.numel() * 4 / 1e9:.2f} GB, "
        f"rank {K} + {NOISE}·U, in {time.perf_counter() - t0:.2f} s")

    errs: dict = {}
    phase_kernels(A, Ht, W, errs)
    phase_small()
    timings = phase_timings(A, Ht, W, errs)
    del Ht, W
    torch.cuda.empty_cache()
    launches, summary = phase_main(
        A, args.seed, (("bpp", 10), ("mu", 3), ("hals", 3)))
    breakdown = phase_breakdown(A, args.seed,
                                (("bpp", 2), ("mu", 3), ("hals", 3)))
    for algo, per in breakdown.items():
        summary[algo]["breakdown_ms"] = per

    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": launches[name], "max_abs_err": errs[name][0],
                "max_err": errs[name][1], **timings[name],
                "kernel_ms": timings[name]["ms"]}
               for name in ("gram", "ts_matmul", "ts_matmul_t")]
    require(all(kv["launches"] > 0 for kv in kernels), "a kernel never ran")
    log(f"[done] {time.perf_counter() - t_start:.1f} s; card {card}")
    log(json.dumps({"main": summary}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
