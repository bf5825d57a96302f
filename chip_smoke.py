#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            # from the root of a checkout

Two paths run, each through ``NMFSolver(k, algo=...).fit(A)`` with k = 50:

* dense: the paper's serial loop on a dense fp32 A at the paper's Video
  shape (m = 1,013,400, n = 13,824; A is 56.04 GB), made on the device from
  ``--seed`` as low rank plus noise, through gram, ts_matmul, ts_matmul_t;
* sparse: ``backend="sparse"`` on an Erdős–Rényi A at m = n = 2^24 with
  Webbase-2001's row density (8.633 nonzeros per row, 144.8 M nonzeros),
  values on (0, 1] made on the device, through spmm and spmm_sorted.

Phases, each of which raises on failure:

  1. card      nvidia-smi's name and power limit;
  2. build     nvcc builds every kernel of the paths from csrc/, in parallel;
  3. data      the dense A on the device;
  4. kernels   each dense kernel against its plain PyTorch version
               (kernels/ref.py) in fp32 and bf16, at the path's widths on a
               65,536-row slice of A and at ragged shapes;
  5. small     the dense path on the card against the CPU path at 96×64;
  6. timings   each dense kernel at the full shape in fp32 against its plain
               version, then timed with CUDA events beside its bound, its
               plain version and one torch.matmul call;
  7. main      fit() at the full shape: bpp for 10 iterations, then mu and
               hals for 3 each, with the launch counters reset just before
               each fit and read just after; the last rel error is checked
               against a direct ||A − WH|| / ||A||;
  8. breakdown ms per iteration in each product and half-update (CUDA
               events around the backend's and the rule's calls);
  9. sparse data      the sparse A as a BlockCOO, its nnz and bytes, and the
               time to build its sorted layout on the device;
 10. sparse kernels   spmm and spmm_sorted, A·B and Aᵀ·C, against their
               plain versions in fp32 and bf16, on the first 65,536 rows and
               at a ragged shape with a hot row and empty tiles;
 11. sparse timings   both kernels and both products at full size in fp32:
               checked, then timed beside their bound, their plain versions
               and one torch.sparse.mm call on a CSR copy;
 12. sparse main      fit() at full size: mu and hals for 3 iterations with
               spmm_impl="sorted" and with "auto" on an unsorted BlockCOO
               (the spmm kernel), bpp for 1 with "sorted"; launch counts,
               finiteness, nonnegativity and a direct float64 error;
 13. sparse breakdown ms per iteration in mm, mm_t, each half-update, the
               grams and the rest, for each rule and impl.

Before the last line it prints the kernels as one JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  ``--m`` and ``--sparse-dim`` cut the two sizes for a
quicker run, and the cut is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
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

# The sparse path keeps Webbase-2001's row density (118,142,155 rows and
# 1,019,903,190 nonzeros; its shape is benchmarks/bench_datasets.py:22) at
# m = n = 2^24, as many rows as one card holds beside the factors.
WEBBASE_ROWS, WEBBASE_NNZ = 118_142_155, 1_019_903_190
SPARSE_DIM = 1 << 24
SPARSE_ALIGN = 64                             # blocksparse.DEFAULT_ALIGN
SPARSE_CHECK_ROWS = 65_536

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
    "spmm": {"source": "src/repro_torch/kernels/csrc/spmm.cu",
             "replaces": "src/repro/kernels/spmm.py:99"},
    "spmm_sorted": {"source": "src/repro_torch/kernels/csrc/spmm.cu",
                    "replaces": "src/repro/kernels/spmm.py:189"},
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
        want = dict.fromkeys(counts, 0)
        want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
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


def timed_segment(A, seed: int, algo: str, iters: int, ops,
                  labels: dict) -> dict:
    """Where an iteration's time goes: CUDA events around each of the
    backend's products and each half-update of ``iters`` fixed iterations
    (the step is the engine's own; only the backend's and the rule's calls
    are wrapped, on the instances).  ``labels`` names the spans of mm, mm_t
    and gram (a name, or a function of the call's operand).  "other" is the
    host-clock wall time minus the spans: the error from byproducts, casts
    and the host loop.  The set-up of a fit (factor init and ||A||²) is
    timed on its own."""
    import torch
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
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

    for method in ("mm", "mm_t", "gram"):
        setattr(ops, method, timed(labels[method], getattr(ops, method)))
    rule = rules.get_rule(algo)
    rule.update_w = timed("update_w", rule.update_w)
    rule.update_h = timed("update_h", rule.update_h)
    solver = NMFSolver(K, algo=rule, backend=ops, max_iters=iters)
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
    del rs
    torch.cuda.empty_cache()
    return per


def phase_breakdown(A, seed: int, runs) -> dict:
    """Phase 8: the dense path's iteration, span by span."""
    from repro_torch.backends import CudaOps
    m = A.shape[0]
    labels = {"mm": "ts_matmul", "mm_t": "ts_matmul_t",
              "gram": lambda X: "gram(W)" if X.shape[0] == m else "gram(Ht)"}
    out = {}
    for algo, iters in runs:
        out[algo] = per = timed_segment(A, seed, algo, iters, CudaOps(),
                                        labels)
        log(f"[breakdown] {algo:4s} ms/iter over {iters} iters: "
            + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
    return out


# ---------------------------------------------------------------------------
# The sparse path: NMFSolver(k, backend="sparse") on a Webbase-shaped matrix
# ---------------------------------------------------------------------------

def sparse_cases(blk, srt, B, C):
    """(kernel, product, kernel call, plain call) for both SpMM kernels and
    both products: A·B (B (n, k)) and Aᵀ·C (C (m, k)); ``blk`` is A's
    unsorted BlockCOO, ``srt`` its sorted copy."""
    from repro_torch.kernels import ops, ref
    m, n = blk.shape
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    row = [t.reshape(-1) for t in (srt.vals, srt.rows, srt.cols,
                                   srt.row_tiles, srt.row_valid)]
    col = [t.reshape(-1) for t in (srt.t_vals, srt.t_rows, srt.t_cols,
                                   srt.col_tiles, srt.col_valid)]
    a = srt.align
    return [
        ("spmm", "A·B", lambda: ops.spmm(v, r, c, B, m),
         lambda: ref.spmm(v, r, c, B, m)),
        ("spmm", "Aᵀ·C", lambda: ops.spmm_t(v, r, c, C, n),
         lambda: ref.spmm(v, c, r, C, n)),
        ("spmm_sorted", "A·B", lambda: ops.spmm_sorted(*row, B, m, align=a),
         lambda: ref.spmm_sorted(*row, B, m, align=a)),
        ("spmm_sorted", "Aᵀ·C",
         lambda: ops.spmm_sorted(*col, C, n, align=a),
         lambda: ref.spmm_sorted(*col, C, n, align=a)),
    ]


def check_sparse(label: str, blk, srt, B, C, errs: dict) -> None:
    import torch
    dname = str(B.dtype).removeprefix("torch.")
    for name, prod, kern, plain in sparse_cases(blk, srt, B, C):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, err = scaled_err(got, want)
        ok = err <= TOL[dname]
        log(f"[sparse kernels] {name:11s} {prod:4s} {dname:8s} {label:6s} "
            f"{blk.shape} nnz {blk.nnz} scaled err {err:.3e} (tol "
            f"{TOL[dname]:.0e}) abs {abs_err:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} {prod} {dname} {label} disagrees with its plain "
                    f"version: {err:.3e} > {TOL[dname]}")
        e = errs.setdefault(name, [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        del got, want


def phase_sparse_data(dev, seed: int, dim: int) -> dict:
    """Phase 9: the Webbase-shaped Erdős–Rényi matrix on the device, as an
    unsorted 1×1 BlockCOO and its sorted copy (timed)."""
    import torch
    from repro_torch.core import blocksparse
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    density = WEBBASE_NNZ / WEBBASE_ROWS / dim
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = blocksparse.blockify(erdos_renyi_bcoo(gen, dim, dim, density), 1, 1)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    srt = blk.sort_rows(align=SPARSE_ALIGN)
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t0
    coo_gb = sum(getattr(blk, f).numel() * getattr(blk, f).element_size()
                 for f in ("vals", "rows", "cols")) / 1e9
    srt_gb = sum(t.numel() * t.element_size() for t in (
        getattr(srt, f) for f in blocksparse.LEAVES)) / 1e9
    log(f"[sparse data] A {blk.shape} fp32, density {density:.4e} "
        f"({WEBBASE_NNZ / WEBBASE_ROWS:.3f} nonzeros per row, Webbase-2001), "
        f"nnz {blk.nnz} ({round(density * dim * dim) - blk.nnz} duplicate "
        f"draws dropped), made in {t_make:.2f} s; COO triplets "
        f"{coo_gb:.3f} GB")
    log(f"[sparse data] sorted layout (align {SPARSE_ALIGN}, both "
        f"orientations) built on the device in {t_sort:.3f} s: "
        f"{srt.vals.numel()} + {srt.t_vals.numel()} packed slots, "
        f"{srt_gb:.3f} GB")
    return {"blk": blk, "srt": srt, "sort_s": t_sort}


def phase_sparse_kernels(blk, errs: dict) -> None:
    """Phase 10: both SpMM kernels and both products against their plain
    versions, fp32 and bf16, on the first 65,536 rows of the matrix and at
    a ragged shape with a hot row and empty tiles."""
    import torch
    from repro_torch.core import blocksparse
    dev = blk.device
    n = blk.shape[1]
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = blk.rows.reshape(-1)
    cut = int((rows < SPARSE_CHECK_ROWS).sum())   # triplets are row-major
    head = blocksparse._pack_triplets(
        blk.vals.reshape(-1)[:cut], rows[:cut], blk.cols.reshape(-1)[:cut],
        SPARSE_CHECK_ROWS, n, 1, 1, cut)
    m_r, n_r, k_r = RAGGED
    dense = torch.rand((m_r, n_r), generator=gen, device=dev)
    dense *= torch.rand((m_r, n_r), generator=gen, device=dev) < 0.002
    dense[1000:3000] = 0                          # empty tiles
    dense[3] = 1.0 - torch.rand(n_r, generator=gen, device=dev)   # hot row
    ragged = blocksparse.blockify(dense, 1, 1)
    del dense
    cases = {"slice": (head, K), "ragged": (ragged, k_r)}
    for dt in (torch.float32, torch.bfloat16):
        for label, (b, k) in cases.items():
            b = dataclasses.replace(b, vals=b.vals.to(dt))
            B = torch.rand((b.shape[1], k), generator=gen, device=dev).to(dt)
            C = torch.rand((b.shape[0], k), generator=gen, device=dev).to(dt)
            check_sparse(label, b, b.sort_rows(align=SPARSE_ALIGN), B, C,
                         errs)
            del b, B, C
    torch.cuda.empty_cache()


def phase_sparse_timings(blk, srt, errs: dict) -> dict:
    """Phase 11: both kernels and both products at full size in fp32:
    held against their plain versions, then timed beside their bound, their
    plain versions and one torch.sparse.mm call on a CSR copy of A (Aᵀ for
    the second product) built before the timed window."""
    import torch
    gen = torch.Generator(device=blk.device).manual_seed(3)
    m, n = blk.shape
    B = torch.rand((n, K), generator=gen, device=blk.device)
    C = torch.rand((m, K), generator=gen, device=blk.device)
    check_sparse("full", blk, srt, B, C, errs)
    nnz = blk.nnz
    # compulsory bytes: the triplets once, the dense operand once, the
    # output once; flops 2·nnz·k
    rb, wb = nnz * 12 + n * K * 4, m * K * 4
    b_ms, b_by = bound_ms(rb, wb, 2.0 * nnz * K, "float32")
    gather_gb = nnz * K * 4 / 1e9
    log(f"[sparse timings] bound {b_ms:.3f} ms ({b_by}) per product from "
        f"{(rb + wb) / 1e9:.2f} GB; the B-row gathers alone move "
        f"{gather_gb:.1f} GB, {gather_gb / HBM_BYTES_PER_S * 1e12:.2f} ms at "
        f"full bandwidth")
    out = {name: {"bound_ms": b_ms, "bound_by": b_by}
           for name in ("spmm", "spmm_sorted")}
    for prod, rhs, offsets, vals, cols, tiles, valid, size in (
            ("A·B", B, srt.row_offsets, srt.vals, srt.cols, srt.row_tiles,
             srt.row_valid, (m, n)),
            ("Aᵀ·C", C, srt.col_offsets, srt.t_vals, srt.t_cols,
             srt.col_tiles, srt.col_valid, (n, m))):
        slot = torch.arange(srt.align, device=blk.device)
        keep = (slot[None, :] < valid.reshape(-1)[:, None]).reshape(-1)
        csr = torch.sparse_csr_tensor(
            offsets.reshape(-1), cols.reshape(-1)[keep],
            vals.reshape(-1)[keep], size, check_invariants=False)
        del keep
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, rhs), 3)
        del csr
        torch.cuda.empty_cache()
        suffix = "" if prod == "A·B" else "_t"
        for name, p, kern, plain in sparse_cases(blk, srt, B, C):
            if p != prod:
                continue
            p1, k1, k2, p2 = (time_ms(f, 3) for f in (plain, kern, kern,
                                                       plain))
            out[name].update({f"ms{suffix}": min(k1, k2),
                              f"plain_ms{suffix}": min(p1, p2),
                              f"library_ms{suffix}": lib_ms})
            log(f"[sparse timings] {name:11s} {prod:4s} fp32 kernel "
                f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms, "
                f"torch.sparse.mm {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by}); {(rb + wb) / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s "
                f"compulsory, {gather_gb / (min(k1, k2) * 1e-3):.0f} GB/s of "
                f"B-row gathers")
    del B, C
    torch.cuda.empty_cache()
    return out


def direct_sparse_rel_error(blk, W, H, chunk: int = 1 << 22) -> float:
    """||A − WH||_F / ||A||_F without the trace trick, in float64: the cross
    term over A's nonzeros, ||WH||² from the two k×k Grams (WH itself would
    be m·n = 2^48 entries)."""
    import torch
    f64 = torch.float64
    Ht = H.T.contiguous()
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    norm = torch.zeros((), dtype=f64, device=W.device)
    cross = torch.zeros((), dtype=f64, device=W.device)
    for s in range(0, v.numel(), chunk):
        a = v[s:s + chunk].to(f64)
        wh = (W[r[s:s + chunk].long()].to(f64)
              * Ht[c[s:s + chunk].long()].to(f64)).sum(1)
        norm += (a * a).sum()
        cross += (a * wh).sum()

    def gram64(X):
        G = torch.zeros((K, K), dtype=f64, device=X.device)
        for r0 in range(0, X.shape[0], chunk):
            Xc = X[r0:r0 + chunk].to(f64)
            G += Xc.T @ Xc
        return G

    quad = (gram64(W) * gram64(Ht)).sum()
    return float(((norm - 2 * cross + quad).clamp_min(0) / norm).sqrt())


def phase_sparse_main(blk, srt, seed: int, runs) -> tuple[dict, dict]:
    """Phase 12: fit() at full size, through the user's entry point, with
    the launch counters reset just before each fit and read just after."""
    import numpy as np
    import torch
    from repro_torch.backends import SparseOps
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = blk.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    for algo, iters, impl in runs:
        A = srt if impl == "sorted" else blk
        kernel = "spmm_sorted" if impl == "sorted" else "spmm"
        solver = NMFSolver(K, algo=algo, backend=SparseOps(spmm_impl=impl),
                           max_iters=iters)
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
        tag = f"{algo:4s} {impl:6s}"
        log(f"[sparse main] {tag} {iters} iters at {(m, n, K)}: fit "
            f"{wall:.2f} s incl. set-up, {wall / iters:.3f} s/iter, peak "
            f"memory {peak:.2f} GB, launches {counts}")
        log(f"[sparse main] {tag} rel errors {rels.tolist()}")
        want = {name: 2 * iters if name == kernel else 0 for name in counts}
        require(counts == want, f"{tag}: launches {counts} != {want}")
        require(rels.shape == (iters,) and np.isfinite(rels).all(),
                f"{tag}: rel errors not finite: {rels}")
        require(tuple(res.W.shape) == (m, K) and tuple(res.H.shape) == (K, n),
                f"{tag}: factor shapes {res.W.shape} {res.H.shape}")
        require(bool(torch.isfinite(res.W).all() and torch.isfinite(res.H).all()
                     and res.W.min() >= 0 and res.H.min() >= 0),
                f"{tag}: factors not finite and nonnegative")
        if algo == "mu":
            require(bool(np.all(np.diff(rels) <= 0)),
                    f"{tag}: mu rel errors increase: {rels}")
        direct = direct_sparse_rel_error(blk, res.W, res.H)
        log(f"[sparse main] {tag} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{tag}: rel error {rels[-1]} disagrees with the direct "
                f"value {direct}")
        launches[kernel] += counts[kernel]
        summary[f"{algo}/{impl}"] = {"iters": iters, "s_per_iter": wall / iters,
                                     "peak_gb": peak,
                                     "rel_errors": rels.tolist()}
        del res
        torch.cuda.empty_cache()
    return launches, summary


def phase_sparse_breakdown(blk, srt, seed: int, runs) -> dict:
    """Phase 13: the sparse path's iteration, span by span ("grams" sums
    the three Grams, plain XᵀX on this path)."""
    from repro_torch.backends import SparseOps
    labels = {"mm": "mm", "mm_t": "mm_t", "gram": "grams"}
    out = {}
    for algo, iters, impl in runs:
        A = srt if impl == "sorted" else blk
        out[f"{algo}/{impl}"] = per = timed_segment(
            A, seed, algo, iters, SparseOps(spmm_impl=impl), labels)
        log(f"[sparse breakdown] {algo:4s} {impl:6s} ms/iter over {iters} "
            f"iters: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items()))
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
    ap.add_argument("--sparse-dim", type=int, default=SPARSE_DIM,
                    help="rows and columns of the sparse matrix; cut only "
                         "if the time limit forces it")
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
    del A
    torch.cuda.empty_cache()

    if args.sparse_dim != SPARSE_DIM:
        log(f"[data] cut: sparse m = n = {args.sparse_dim} of {SPARSE_DIM}")
    sp = phase_sparse_data(dev, args.seed, args.sparse_dim)
    phase_sparse_kernels(sp["blk"], errs)
    timings.update(phase_sparse_timings(sp["blk"], sp["srt"], errs))
    sp_launches, sp_summary = phase_sparse_main(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 3, "sorted"), ("mu", 3, "auto"), ("hals", 3, "sorted"),
         ("hals", 3, "auto"), ("bpp", 1, "sorted")))
    for name in ("spmm", "spmm_sorted"):
        launches[name] = sp_launches[name]
    sp_breakdown = phase_sparse_breakdown(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 2, "sorted"), ("mu", 2, "auto"), ("hals", 2, "sorted"),
         ("hals", 2, "auto"), ("bpp", 1, "sorted")))
    for key, per in sp_breakdown.items():
        sp_summary[key]["breakdown_ms"] = per
    summary["sparse"] = {"shape": sp["blk"].shape, "nnz": sp["blk"].nnz,
                         "sort_s": sp["sort_s"], "fits": sp_summary}
    del sp

    kernels = [{"name": name, "route": "cuda", **KERNELS[name],
                "launches": launches[name], "max_abs_err": errs[name][0],
                "max_err": errs[name][1], **timings[name],
                "kernel_ms": timings[name]["ms"]}
               for name in KERNELS]
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
