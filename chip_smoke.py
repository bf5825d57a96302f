#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py            # from the root of a checkout

Three paths run, at k = 50:

* dense: the paper's serial loop, ``NMFSolver(k, algo=...).fit(A)``, on a
  dense fp32 A at the paper's Video shape (m = 1,013,400, n = 13,824; A is
  56.04 GB), made on the device from ``--seed`` as low rank plus noise,
  through gram, ts_matmul, ts_matmul_t, and for the MU/HALS rules (mu,
  hals, amu, ahals) mu_update and hals_sweep;
* sparse: ``backend="sparse"`` on an Erdős–Rényi A at m = n = 2^24 with
  Webbase-2001's row density (8.633 nonzeros per row, 144.8 M nonzeros),
  values on (0, 1] made on the device, through spmm and spmm_sorted (and
  the LUC kernels);
* serving: ``FactorArtifact`` → ``FoldInProjector`` → ``TopK`` on the
  factors of the dense bpp fit (saved and loaded on local disk) and of the
  sparse mu fit (in memory), for dense and sparse request rows.

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
               plain version and one torch.matmul call; ts_matmul also at a
               served column batch's shape (256 × 1,013,400 · W), gram's
               slab kernel and reduction apart, and ts_matmul, ts_matmul_t
               and gram (and their plain versions) against float64 on 2,048
               rows;
  4b. luc      mu_update and hals_sweep against their plain versions in fp32
               and bf16, with ε = 1e-16 and ε = eps_for, at ragged shapes
               (k = 1, 50, 128) and at Video's W (1,013,400 × 50), with a
               row whose X·G is 0 and a zero diagonal entry of G; timed at
               full width beside their bound and plain versions;
  7. main      fit() at the full shape: bpp for 10 iterations, then mu and
               hals for 3 each, with the launch counters reset just before
               each fit and read just after; the last rel error is checked
               against a direct ||A − WH|| / ||A||;
  7b. accel    amu and ahals (inner_iters=4, delta=0.01) for 3 iterations:
               ms/iter, the inner sweep counts, which the LUC launch counts
               must equal, and the rel error against the direct value;
  8. breakdown ms per iteration in each product and half-update (CUDA
               events around the backend's and the rule's calls);
  8b. serve    the bpp fit published as a FactorArtifact, saved and loaded
               (checksums verified), then FoldInProjector for bpp, mu, hals,
               amu and ahals (iters=100) on b = 1, 7, 64, 256 new rows and,
               through ``transposed()``, new columns: per-batch latency,
               launch counts; each result against the same fold with the
               plain LUC versions on the same R, R against its plain
               product, and both results' residuals ||a − xH||; TopK
               (cosine, k = 10) over W's rows, checked against a direct
               top-k;
  9. sparse data      the sparse A as a BlockCOO, its nnz and bytes, and the
               time to build its sorted layout on the device;
 10. sparse kernels   spmm and spmm_sorted, A·B and Aᵀ·C, against their
               plain versions in fp32 and bf16, on the first 65,536 rows and
               at a ragged shape with a hot row and empty tiles;
 11. sparse timings   both kernels and both products at full size in fp32:
               checked, then timed beside their bound, their plain versions
               and one torch.sparse.mm call on a CSR copy; spmm on the plan
               its wrapper chooses and on the other one (the L2-blocked
               scatter or a single pass), each checked and timed, with the
               plan and the rate printed;
 12. sparse main      fit() at full size: mu and hals for 3 iterations with
               spmm_impl="sorted" and with "auto" on an unsorted BlockCOO
               (the spmm kernel), bpp for 1 with "sorted"; launch counts,
               finiteness, nonnegativity and a direct float64 error;
 12b. sparse accel / luc  ahals for 2 iterations; mu_update and hals_sweep
               at the 2^24 × 50 factor, checked and timed;
 13. sparse breakdown ms per iteration in mm, mm_t, each half-update, the
               grams and the rest, for mu and hals with each impl and for
               amu and ahals with the sorted one (bpp's
               one-iteration breakdown is left out to keep the run short;
               phase 12 times its iteration whole);
 14. sparse serve  an artifact of the sparse mu fit, in memory; sparse
               request rows at the matrix's density (b = 1, 256) through
               the spmm kernel (checked to take its single pass) and a
               hals fold-in, and each request's product timed on its
               single pass and on a forced L2-blocked scatter; TopK over
               W's 2^24 rows.

Before the last line it prints the kernels as one JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.  ``--m`` and ``--sparse-dim`` cut the two sizes for a
quicker run, and the cut is printed.
"""

from __future__ import annotations

import argparse
import contextlib
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
F64_ROWS = 2_048                              # rows held against float64
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
F64_ROWS = 2_048                              # rows held against float64

# H100 SXM (NVIDIA data sheet): fp32 outside the tensor cores, dense TF32
# and bf16 on them, HBM3.  ts_matmul and gram run fp32 as three TF32
# products (3xTF32), so their bounds count three times the useful
# operations at the TF32 rate.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
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
    "mu_update": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                  "replaces": "src/repro/kernels/mu_update.py:36"},
    "hals_sweep": {"source": "src/repro_torch/kernels/csrc/luc.cu",
                   "replaces": "src/repro/kernels/hals_sweep.py:53"},
}

LUC_RAGGED = ((4_099, 50), (4_099, 1), (4_099, 128))
SERVE_BATCHES = (1, 7, 64, 256)
SERVE_ALGOS = ("bpp", "mu", "hals", "amu", "ahals")
# A served batch is held against the same projection with the LUC kernels
# replaced by their plain versions on the same R (scaled, 100 sweeps of
# rounding), and R itself against its plain product (fp32 tolerance; 1e-4
# for a dense contraction longer than 65,536: the transposed fold's
# 1,013,400-term sums, which the ts_matmul kernel adds in order in one
# block where cuBLAS splits them); the two solutions of min ||a - xH||,
# x >= 0, must leave the same residual relative to ||a||.  R is held apart
# because the fold amplifies R's rounding where G is ill-conditioned (the
# transposed fold's G = WᵀW).
SERVE_TOL = {"codes": 1e-3, "product": 1e-5, "long product": 1e-4,
             "residual": 1e-5}
LONG_CONTRACTION = 65_536
TOPK_CHECK_ROWS = 65_536
F64_ROWS = 2_048                              # rows held against float64


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


def col_scaled_err(got, want) -> tuple[float, float]:
    """(max |got − want|, the largest over columns of that column's max
    |got − want| over its max |want|): a column of huge values (the ε
    guard) cannot hide the error of the others."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(0).clamp_min(1e-30)
    return diff.max().item(), (diff.amax(0) / scale).max().item()


@contextlib.contextmanager
def plain_luc():
    """The LUC kernel wrappers of ``kernels.ops`` replaced by their plain
    versions (``kernels.ref``): the same projector's fold-in math without
    the LUC kernels, which a served batch is held against on the card."""
    from repro_torch.kernels import ops, ref
    saved = ops.mu_update, ops.hals_sweep
    ops.mu_update = lambda X, G, R, *, eps=ref.LUC_EPS: ref.mu_update(
        X, G, R, eps)
    ops.hals_sweep = lambda X, G, R, *, eps=ref.LUC_EPS: ref.hals_sweep(
        X, G, R, eps)
    try:
        yield
    finally:
        ops.mu_update, ops.hals_sweep = saved


def add_launches(total: dict, counts: dict) -> None:
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"[card] {out}")
    return out


def kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel of ptxas's log, e.g.
    ``ts_matmul_tc_kernel<f32,7>``."""
    import re
    for num in re.finditer(r"\d+", mangled):
        end = num.end() + int(num.group())
        name, rest = mangled[num.end():end], mangled[end:]
        if not name.endswith("_kernel"):
            continue
        if not rest.startswith("I") or "EEv" not in rest:
            return name
        names = {"13__nv_bfloat16": "bf16", "f": "f32", "Lb1E": "true",
                 "Lb0E": "false"}
        args = [names.get(a, a[2:-1]) for a in re.findall(
            r"13__nv_bfloat16|Li\d+E|Lb[01]E|f", rest[1:rest.index("EEv")])]
        return f"{name}<{','.join(args)}>"
    return mangled


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {build.BUILD_DIR}")
    for name in paths:
        kernel = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {kernel}: {line.strip()}")


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


def luc_problem(gen, r: int, k: int, x_dtype, r_dtype):
    """X (r, k) with a zero row (X·G = 0: the ε of the MU denominator), G a
    Gram with a zero diagonal entry when k > 2 (the sweep divides by ε),
    R (r, k)."""
    import torch
    dev = gen.device
    X = torch.rand((r, k), generator=gen, device=dev)
    X[r // 2] = 0.0
    C = torch.rand((64, k), generator=gen, device=dev)
    if k > 2:
        C[:, 2] = 0.0
    R = torch.rand((r, k), generator=gen, device=dev) * 5
    return X.to(x_dtype), C.T @ C, R.to(r_dtype)


def phase_luc(dev, cases, errs: dict, label: str, time_rows: int) -> dict:
    """mu_update and hals_sweep against their plain versions: each case
    (r, k) in fp32 and with a bf16 carry (fp32 R), with ε = 1e-16 and
    ε = eps_for; then both timed in fp32 at (time_rows, 50) beside their
    bound, their plain versions and (mu) the three-op torch expression."""
    import torch
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    for (r, k), (dname, xdt) in (
            (c, d) for c in cases
            for d in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16))):
        X, G, R = luc_problem(gen, r, k, xdt, torch.float32)
        for eps in (ref.LUC_EPS, eps_for(xdt)):
            for name in ("mu_update", "hals_sweep"):
                got = getattr(ops, name)(X, G, R, eps=eps)
                want = getattr(ref, name)(X, G, R, eps)
                torch.cuda.synchronize()
                abs_err, err = col_scaled_err(got, want)
                ok = (err <= TOL[dname] and got.dtype == xdt
                      and bool(torch.isfinite(got.float()).all()))
                log(f"[luc] {name:10s} {dname:8s} {label:6s} {(r, k)} "
                    f"eps {eps:.1e} column-scaled err {err:.3e} (tol "
                    f"{TOL[dname]:.0e}) abs {abs_err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"{name} {dname} {(r, k)} eps {eps} disagrees "
                            f"with its plain version: {err:.3e}")
                e = errs.setdefault(name, [0.0, 0.0])
                e[0], e[1] = max(e[0], abs_err), max(e[1], err)
                del got, want
        del X, G, R
    torch.cuda.empty_cache()
    r, k = time_rows, K
    X, G, R = luc_problem(gen, r, k, torch.float32, torch.float32)
    eps = eps_for(torch.float32)
    # X and R read once, the output written once; 2·r·k² flops
    b_ms, b_by = bound_ms(8 * r * k, 4 * r * k, 2.0 * r * k * k, "float32")
    out = {}
    for name, reps in (("mu_update", 20), ("hals_sweep", 20)):
        kern = lambda: getattr(ops, name)(X, G, R, eps=eps)
        plain = lambda: getattr(ref, name)(X, G, R, eps)
        p1, k1, k2, p2 = (time_ms(f, n) for f, n in (
            (plain, 3), (kern, reps), (kern, reps), (plain, 3)))
        row = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        extra = ""
        if name == "mu_update":
            row["torch_expr_ms"] = time_ms(
                lambda: X * (R / (torch.matmul(X, G) + eps)), 3)
            extra = (f", the three-op torch expression "
                     f"{row['torch_expr_ms']:.3f} ms")
        out[name] = row
        log(f"[luc timings] {name:10s} fp32 {label} {(r, k)} kernel "
            f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms{extra}, "
            f"bound {b_ms:.3f} ms ({b_by}); "
            f"{12 * r * k / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    del X, G, R
    torch.cuda.empty_cache()
    return out


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
    """Each kernel at the full shape, and ts_matmul at a served column
    batch's shape: held against its plain version there (the slab plan and
    64-bit offsets of A differ from the slice's), then timed beside its
    bound, its plain version and one torch.matmul call; gram's slab kernel
    and reduction are also timed apart.  ts_matmul and gram, and their
    plain versions, are held against float64 on the first rows."""
    import torch
    from repro_torch.kernels import ops, ref
    m, n = A.shape
    k = Ht.shape[1]
    f4 = 4
    b = max(SERVE_BATCHES)
    C = A[:, :b].T.contiguous()      # b request columns, as phase 8b serves
    # (key, kernel, plain, library call, bytes read, bytes written, useful
    # flops, the units' rate, reps).  ts_matmul, ts_matmul_t and gram run
    # three TF32 products on the tensor cores; XᵀX is symmetric: its k·(k+1)/2
    # distinct entries need r multiply-adds each.
    plans = {
        "ts_matmul": (lambda: ops.ts_matmul(A, Ht),
                      lambda: ref.ts_matmul(A, Ht),
                      lambda: torch.matmul(A, Ht),
                      (m * n + n * k) * f4, m * k * f4, 2.0 * m * n * k,
                      "tf32", 3),
        "ts_matmul serve": (lambda: ops.ts_matmul(C, W),
                            lambda: ref.ts_matmul(C, W),
                            lambda: torch.matmul(C, W),
                            (b * m + m * k) * f4, b * k * f4,
                            2.0 * b * m * k, "tf32", 20),
        "ts_matmul_t": (lambda: ops.ts_matmul_t(A, W),
                        lambda: ref.ts_matmul_t(A, W),
                        lambda: torch.matmul(A.T, W),
                        (m * n + m * k) * f4, n * k * f4, 2.0 * m * n * k,
                        "tf32", 3),
        "gram": (lambda: ops.gram(W), lambda: ref.gram(W),
                 lambda: torch.matmul(W.T, W),
                 m * k * f4, k * k * f4, 1.0 * m * k * (k + 1), "tf32", 20),
    }
    for name, (kern, plain, *_) in plans.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err, err = scaled_err(got, want)
        ok = err <= TOL["float32"]
        shape = {"gram": tuple(got.shape), "ts_matmul serve": tuple(C.shape)}
        log(f"[kernels] {name:15s} float32  full   "
            f"{shape.get(name, tuple(A.shape))} scaled "
            f"err {err:.3e} (tol {TOL['float32']:.0e}) abs {abs_err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        require(ok, f"{name} float32 at the full shape disagrees with its "
                    f"plain version: {err:.3e} > {TOL['float32']}")
        e = errs.setdefault(name.split()[0], [0.0, 0.0])
        e[0], e[1] = max(e[0], abs_err), max(e[1], err)
        del got, want
    # both against float64 on a slice: the distance to the plain version
    # above is that version's own fp32 rounding as much as the kernel's
    rows = min(F64_ROWS, m)
    a_s, w_s = A[:rows], W[:rows]
    f64 = {"ts_matmul": (ops.ts_matmul(a_s, Ht), ref.ts_matmul(a_s, Ht),
                         a_s.double() @ Ht.double()),
           "ts_matmul_t": (ops.ts_matmul_t(a_s, w_s), ref.ts_matmul_t(a_s, w_s),
                           a_s.double().T @ w_s.double()),
           "gram": (ops.gram(w_s), ref.gram(w_s), w_s.double().T @ w_s.double())}
    for name, (got, plain, want) in f64.items():
        torch.cuda.synchronize()
        k_err, p_err = (scaled_err(x.double(), want)[1] for x in (got, plain))
        log(f"[kernels] {name:15s} float32  vs float64 on {rows} rows: kernel "
            f"{k_err:.3e}, plain version {p_err:.3e} (scaled)")
        f64[name] = {"f64_err": k_err, "plain_f64_err": p_err}
    del a_s, w_s
    out = {name: dict(errs64) for name, errs64 in f64.items()}
    for name, (kern, plain, lib, rb, wb, flops, units, reps) in plans.items():
        # in turns: plain, kernel, kernel, plain (then the library call)
        p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kern, kern, plain))
        lib_ms = time_ms(lib, reps)
        # the bound at the rate of the units the kernel uses (3xTF32: three
        # products on the tensor cores)
        n_ops = 3 * flops if units == "tf32" else flops
        b_ms, b_by = bound_ms(rb, wb, n_ops, units)
        key, suffix = (name.split()[0],
                       "_serve" if name.endswith("serve") else "")
        row = out.setdefault(key, {})
        row.update({f"ms{suffix}": min(k1, k2), f"plain_ms{suffix}": min(p1, p2),
                    f"library_ms{suffix}": lib_ms,
                    f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by})
        extra = ""
        if units == "tf32":
            cores_ms, _ = bound_ms(rb, wb, flops, "float32")
            row[f"bound_ms_fp32_cores{suffix}"] = cores_ms
            extra = f" (on the fp32 cores {cores_ms:.3f} ms)"
        log(f"[timings] {name:15s} fp32 kernel {k1:.3f}/{k2:.3f} ms, plain "
            f"{p1:.3f}/{p2:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by}){extra}; "
            f"{flops / (min(k1, k2) * 1e-3) / 1e12:.1f} TFLOP/s useful, "
            f"{(rb + wb) / (min(k1, k2) * 1e-3) / 1e9:.0f} GB/s")
    out["ts_matmul"]["serve_shape"] = [b, m, k]
    del C
    main, reduce = ops.gram_parts(W)
    main_ms, reduce_ms = time_ms(main, 20), time_ms(reduce, 20)
    plan = ops.plan_gram(m, k, W.element_size(),
                         torch.cuda.get_device_properties(
                             W.device).multi_processor_count)
    out["gram"].update({"main_ms": main_ms, "reduce_ms": reduce_ms,
                        "slabs": plan.slabs})
    log(f"[timings] gram(W) apart: slab kernel {main_ms:.4f} ms ({plan.slabs} "
        f"slabs of {plan.slab} rows, panels of {plan.panel}), reduction "
        f"{reduce_ms:.4f} ms")
    g_ht = time_ms(lambda: ops.gram(Ht), 50)
    b_ht, by_ht = bound_ms(n * k * f4, k * k * f4, 3.0 * n * k * (k + 1),
                           "tf32")
    out["gram"]["ms_gram_ht"] = g_ht
    log(f"[timings] gram(Ht)        fp32 kernel {g_ht:.4f} ms at {(n, k)}, "
        f"bound {b_ht:.4f} ms ({by_ht})")
    return out


#: LUC launches per iteration of a plain rule's fit: MU updates both halves
#: through mu_update; HALS only its H-step through hals_sweep (the W-step's
#: normalised sweep stays a plain column loop)
LUC_PER_ITER = {"mu": {"mu_update": 2}, "hals": {"hals_sweep": 1}, "bpp": {}}


def phase_main(A, seed: int, runs) -> tuple[dict, dict, object]:
    """Phase 7; also returns the bpp fit, which phase 8b serves."""
    import numpy as np
    import torch
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = A.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    kept = None
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
        want.update({name: c * iters
                     for name, c in LUC_PER_ITER[algo].items()})
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
        if algo == "bpp":
            kept = res
        del res
        torch.cuda.empty_cache()
    return launches, summary, kept


def phase_accel(A, seed: int, runs, backend=None, label="accel") -> tuple:
    """Phase 7b (and 12b): the accelerated rules, inner_iters=4 and
    delta=0.01, through fit(); the launch counters reset just before each
    fit and read just after.  The LUC launches must equal the inner sweeps
    the rule state counted (amu: both halves through mu_update; ahals: its
    H sweeps through hals_sweep, its normalised W sweeps in plain torch)."""
    import numpy as np
    import torch
    from repro_torch.core import rules
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    sparse = backend is not None
    m, n = A.shape
    launches, summary = {}, {}
    for algo, iters in runs:
        rule = type(rules.get_rule(algo))(inner_iters=4, delta=0.01)
        solver = NMFSolver(K, algo=rule, max_iters=iters,
                           **({"backend": backend} if sparse else {}))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = solver.fit(A, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        st = res.extras["rule_state"]
        rels = res.rel_errors.numpy()
        log(f"[{label}] {algo:5s} {iters} iters at {(m, n, K)}: fit "
            f"{wall:.2f} s incl. set-up, {wall / iters:.3f} s/iter; inner "
            f"sweeps {st}; launches {counts}")
        log(f"[{label}] {algo:5s} rel errors {rels.tolist()}")
        luc = ({"mu_update": st["inner_w"] + st["inner_h"]} if algo == "amu"
               else {"hals_sweep": st["inner_h"]})
        want = dict.fromkeys(counts, 0)
        if sparse:
            want["spmm_sorted"] = 2 * iters
        else:
            want.update(gram=3 * iters, ts_matmul=iters, ts_matmul_t=iters)
        want.update(luc)
        require(counts == want, f"{label} {algo}: launches {counts} != "
                                f"{want}")
        require(iters <= st["inner_w"] <= 4 * iters
                and iters <= st["inner_h"] <= 4 * iters,
                f"{label} {algo}: inner sweep counts {st} outside "
                f"[{iters}, {4 * iters}]")
        require(np.isfinite(rels).all() and bool(
            torch.isfinite(res.W).all() and res.W.min() >= 0
            and res.H.min() >= 0), f"{label} {algo}: factors or rel errors "
                                   f"not finite and nonnegative")
        direct = (direct_sparse_rel_error(A, res.W, res.H) if sparse
                  else direct_rel_error(A, res.W, res.H))
        log(f"[{label}] {algo:5s} direct ||A-WH||/||A|| {direct:.6f} vs "
            f"trace-trick {rels[-1]:.6f}")
        require(abs(direct - rels[-1]) <= 1e-2 * direct,
                f"{label} {algo}: rel error {rels[-1]} disagrees with the "
                f"direct value {direct}")
        add_launches(launches, counts)
        summary[algo] = {"iters": iters, "s_per_iter": wall / iters,
                         "inner": dict(st), "rel_errors": rels.tolist()}
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
    # A·B as local_spmm calls it, with the BlockCOO's row order
    return [
        ("spmm", "A·B",
         lambda **plan: ops.spmm(v, r, c, B, m, row_major=blk.row_major,
                                 **plan),
         lambda: ref.spmm(v, r, c, B, m)),
        ("spmm", "Aᵀ·C", lambda **plan: ops.spmm_t(v, r, c, C, n, **plan),
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
        SPARSE_CHECK_ROWS, n, 1, 1, cut, row_major=blk.row_major)
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
    sms = torch.cuda.get_device_properties(blk.device).multi_processor_count
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
            if name == "spmm":
                out[name].update(spmm_plans(
                    prod, kern, plain, rb + wb, suffix,
                    (nnz, m if prod == "A·B" else n, K, 4, sms,
                     prod == "A·B" and blk.row_major)))
    del B, C
    torch.cuda.empty_cache()
    return out


def spmm_plans(prod: str, kern, plain, nbytes: int, suffix: str,
               plan_args: tuple) -> dict:
    """spmm on the plan its wrapper chose for ``kern`` and on the other one
    (the L2-blocked scatter, or a single pass): the other checked against
    the plain version, both timed in turns, both plans printed.
    ``plan_args``: (nnz, m_out, k, itemsize, SMs, row_major) of the call."""
    import torch
    from repro_torch.kernels import ops
    nnz, m_out, k, size, sms, row_major = plan_args
    chosen = ops.plan_spmm(nnz, m_out, k, size, sms, row_major=row_major)
    other = ops.plan_spmm(nnz, m_out, k, size, sms, row_major=row_major,
                          bucketed=chosen.buckets == 1)
    other_call = lambda: kern(plan=other)
    _, err = scaled_err(other_call(), plain())
    torch.cuda.synchronize()
    require(err <= TOL["float32"], f"spmm {prod} on the other plan {other} "
                                   f"disagrees with its plain version: {err}")
    c1, o1, o2, c2 = (time_ms(f, 3) for f in (kern, other_call, other_call,
                                              kern))
    res = {}
    for tag, plan, t1, t2 in (("plan", chosen, c1, c2),
                              ("other", other, o1, o2)):
        log(f"[sparse timings] spmm        {prod:4s} {tag:5s} buckets "
            f"{plan.buckets} (2^{plan.shift} rows), scratch "
            f"{plan.scratch_bytes / 1e9:.3f} GB, {plan.per_warp} triplets a "
            f"warp: {t1:.3f}/{t2:.3f} ms, "
            f"{nbytes / (min(t1, t2) * 1e-3) / 1e9:.0f} GB/s compulsory"
            + (f"; scaled err {err:.3e}" if tag == "other" else ""))
        res[f"{tag}_ms{suffix}"] = min(t1, t2)
        res[f"{tag}_buckets{suffix}"] = plan.buckets
        res[f"{tag}_scratch_bytes{suffix}"] = plan.scratch_bytes
    return res


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


def phase_sparse_main(blk, srt, seed: int, runs) -> tuple[dict, dict, object]:
    """Phase 12: fit() at full size, through the user's entry point, with
    the launch counters reset just before each fit and read just after.
    Also returns the mu fit on the sorted layout, which phase 14 serves."""
    import numpy as np
    import torch
    from repro_torch.backends import SparseOps
    from repro_torch.core.engine import NMFSolver
    from repro_torch.kernels import ops
    m, n = blk.shape
    launches = {name: 0 for name in ops.LAUNCHES}
    summary = {}
    kept = None
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
        want.update({name: c * iters
                     for name, c in LUC_PER_ITER[algo].items()})
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
        add_launches(launches, counts)
        summary[f"{algo}/{impl}"] = {"iters": iters, "s_per_iter": wall / iters,
                                     "peak_gb": peak,
                                     "rel_errors": rels.tolist()}
        if (algo, impl) == ("mu", "sorted"):
            kept = res
        del res
        torch.cuda.empty_cache()
    return launches, summary, kept


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


# ---------------------------------------------------------------------------
# Serving: FactorArtifact -> FoldInProjector -> TopK
# ---------------------------------------------------------------------------

def fold_residual(proj, req, X):
    """||a − x H|| / ||a|| per request row, in float64 from the Gram form
    ||a||² − 2 x·(a Hᵀ) + x G xᵀ (no (b, n) product of a wide request)."""
    import torch
    Ht = proj.Ht.double()
    if req.layout == torch.strided:
        a = req.double()
        a2, R = (a * a).sum(1), a @ Ht
    else:
        idx, v = req._indices(), req._values().double()
        b = req.shape[0]
        a2 = torch.zeros(b, dtype=torch.float64, device=v.device).index_add_(
            0, idx[0], v * v)
        R = torch.zeros((b, Ht.shape[1]), dtype=torch.float64,
                        device=v.device).index_add_(
            0, idx[0], v[:, None] * Ht[idx[1]])
    Xd = X.double()
    r2 = a2 - 2 * (Xd * R).sum(1) + ((Xd @ proj.G.double()) * Xd).sum(1)
    return (r2.clamp_min(0) / a2.clamp_min(1e-300)).sqrt()


def product_err(proj, req) -> tuple[float, float]:
    """(scaled error, tolerance) of the request's cross product R = a·Hᵀ
    through its kernel (ts_matmul, or spmm for a sparse request) against
    the plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    tol = SERVE_TOL["product"]
    if req.layout == torch.strided:
        got, want = ops.ts_matmul(req, proj.Ht), ref.ts_matmul(req, proj.Ht)
        if req.shape[1] > LONG_CONTRACTION:
            tol = SERVE_TOL["long product"]
    else:
        idx = req._indices().to(torch.int32)
        args = (req._values(), idx[0].contiguous(), idx[1].contiguous(),
                proj.Ht, req.shape[0])
        got, want = ops.spmm(*args), ref.spmm(*args)
    return scaled_err(got, want)[1], tol


def serve_batches(proj, requests, label: str, algo: str, kernel_of: dict,
                  iters: int) -> tuple[dict, dict]:
    """Answer each (b, request) of ``requests`` with ``proj``: one warm-up
    call, then a host-clock timed, synchronised call with the launch
    counters reset just before it and read just after, then the checks of
    SERVE_TOL (outside the counted window).  Returns (per-b latency ms,
    launches of the timed calls) and the last batch's codes."""
    import torch
    from repro_torch.kernels import ops
    lat, launches, codes = {}, {}, None
    for b, req, product in requests:
        proj.project(req)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        got = proj.project(req)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        # a sparse batch's output (b ≤ 256 rows, padded to its bucket) fits
        # L2: spmm's single pass
        single = product != "spmm" or ops.plan_spmm(
            req._nnz(), next(s for s in proj.buckets if s >= b), K, 4,
            torch.cuda.get_device_properties(0).multi_processor_count
        ).buckets == 1
        with plain_luc():
            want = proj.project(req)
        torch.cuda.synchronize()
        _, err = scaled_err(got, want)
        r_err, r_tol = product_err(proj, req)
        res_got, res_want = (fold_residual(proj, req, X) for X in (got, want))
        res_diff = (res_got - res_want).abs().max().item()
        kernel = kernel_of.get(algo)
        luc = counts.get(kernel, 0) if kernel else 0
        ok = (tuple(got.shape) == (b, K) and bool(torch.isfinite(got).all())
              and got.min().item() >= 0 and err <= SERVE_TOL["codes"]
              and r_err <= r_tol
              and res_diff <= SERVE_TOL["residual"]
              and counts[product] == 1 and single
              and (luc == iters if algo in ("mu", "hals") else
                   1 <= luc <= iters if kernel else
                   counts["mu_update"] == counts["hals_sweep"] == 0))
        log(f"[{label}] {algo:5s} b={b:4d} {ms:9.3f} ms; launches "
            f"{ {k: v for k, v in counts.items() if v} }; against the plain "
            f"versions: codes {err:.2e} (tol {SERVE_TOL['codes']:.0e}), R "
            f"{r_err:.2e} (tol {r_tol:.0e}), rel residual {res_diff:.2e} "
            f"(tol {SERVE_TOL['residual']:.0e}, of max "
            f"{res_got.max().item():.6f})"
            + ("; spmm single pass" if product == "spmm" and single else "")
            + f" {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} {algo} b={b}: shape {tuple(got.shape)}, "
                    f"launches {counts}, codes {err:.3e}, R {r_err:.3e}, "
                    f"residual {res_diff:.3e}, spmm single pass {single}")
        lat[b] = ms
        add_launches(launches, counts)
        codes = got
    return lat, launches, codes


def check_topk(tk, codes, label: str) -> dict:
    """TopK over all of W (timed, host clock, synchronised), and the
    streaming scan over W's first rows against a direct full-score top-k
    there: the same scores, and each returned index scoring its value."""
    import torch
    from repro_torch.serve.topk import topk_rows
    tk.query(codes, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, idx = tk.query(codes, k=10)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rows = min(TOPK_CHECK_ROWS, tk.W.shape[0])
    W, norms = tk.W[:rows], tk.row_norms[:rows]
    v, i = topk_rows(W, codes, k=10, gram=tk.gram, metric="cosine",
                     row_norms=norms)
    Q = codes.float()
    Qt = Q @ tk.gram
    qn = torch.clamp_min(torch.sqrt(torch.clamp_min((Qt * Q).sum(1), 0)),
                         1e-12)
    full = (Qt @ W.T) / (torch.clamp_min(norms, 1e-12)[None, :] * qn[:, None])
    dv, _ = torch.topk(full, 10, dim=1)
    at = torch.gather(full, 1, i)
    err = max((v - dv).abs().max().item(), (at - v).abs().max().item())
    ok = (tuple(idx.shape) == (codes.shape[0], 10) and err <= 1e-5
          and bool((vals[:, :-1] >= vals[:, 1:]).all()))
    log(f"[{label}] TopK cosine k=10 over {tk.W.shape[0]} rows, "
        f"b={codes.shape[0]}: {ms:.3f} ms; scan vs direct top-k on the first "
        f"{rows} rows: max err {err:.2e} (tol 1e-05) {'ok' if ok else 'FAIL'}")
    require(ok, f"{label}: top-k disagrees with the direct scores: {err}")
    return {"rows": tk.W.shape[0], "b": codes.shape[0], "ms": ms}


def phase_serve_dense(A, res) -> tuple[dict, dict]:
    """Phase 8b: publish the bpp fit, save and load it (checksums verified),
    fold new rows and new columns in with every algorithm, then top-k."""
    import torch
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    art = FactorArtifact.from_result(res, corpus="chip_smoke video")
    path = os.path.join(ROOT, "build", "serve", "video_bpp")
    t0 = time.perf_counter()
    art.save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = FactorArtifact.load(path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    HHt = torch.matmul(res.H, res.H.T)
    _, gerr = scaled_err(loaded.gram, HHt)
    ok = (torch.equal(loaded.W, art.W) and torch.equal(loaded.H, art.H)
          and torch.equal(loaded.gram, art.gram) and loaded.algo == "bpp"
          and loaded.meta == art.meta and gerr <= TOL["float32"])
    log(f"[serve] artifact W {tuple(art.W.shape)} H {tuple(art.H.shape)}: "
        f"saved in {t_save:.2f} s, loaded and verified in {t_load:.2f} s; "
        f"gram vs HHᵀ scaled err {gerr:.2e} {'ok' if ok else 'FAIL'}")
    require(ok, "the artifact does not round-trip through disk")
    kernel_of = {"mu": "mu_update", "amu": "mu_update", "hals": "hals_sweep",
                 "ahals": "hals_sweep"}
    art_t = loaded.transposed()
    rows = A[-max(SERVE_BATCHES):]
    cols = A[:, :max(SERVE_BATCHES)].T.contiguous()
    launches, summary = {}, {"save_s": t_save, "load_s": t_load}
    codes = None
    for algo in SERVE_ALGOS:
        for label, a, req in (("serve rows", loaded, rows),
                              ("serve cols", art_t, cols)):
            proj = FoldInProjector(a, algo=algo, iters=100, backend="cuda")
            reqs = [(b, req[:b], "ts_matmul") for b in SERVE_BATCHES]
            lat, counts, last = serve_batches(proj, reqs, label, algo,
                                              kernel_of, 100)
            add_launches(launches, counts)
            summary[f"{label.split()[1]}/{algo}"] = lat
            if label == "serve rows" and algo == "bpp":
                codes = last
            del proj
    del cols, art_t
    torch.cuda.empty_cache()
    summary["topk"] = check_topk(TopK(loaded, metric="cosine"), codes,
                                 "serve topk")
    return launches, summary


def phase_serve_sparse(res, dim: int, seed: int) -> tuple[dict, dict]:
    """Phase 14: the sparse mu fit as an artifact in memory; sparse request
    rows at the matrix's density through the spmm kernel and a hals
    fold-in; top-k over W's rows."""
    import torch
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    art = FactorArtifact.from_result(res)
    gen = torch.Generator(device=res.W.device).manual_seed(seed + 14)
    density = WEBBASE_NNZ / WEBBASE_ROWS / dim
    reqs = []
    for b in (1, 256):
        req = erdos_renyi_bcoo(gen, b, dim, density)
        log(f"[serve sparse] request b={b}: {req._nnz()} nonzeros over "
            f"{dim} columns")
        reqs.append((b, req, "spmm"))
    proj = FoldInProjector(art, algo="hals", iters=100)
    lat, launches, codes = serve_batches(proj, reqs, "serve sparse", "hals",
                                         {"hals": "hals_sweep"}, 100)
    plans = served_spmm_plans(proj.Ht, reqs)
    del proj
    torch.cuda.empty_cache()
    topk = check_topk(TopK(art, metric="cosine"), codes, "serve sparse topk")
    return launches, {"hals": lat, "topk": topk, "spmm_plans": plans}


def served_spmm_plans(Ht, reqs) -> dict:
    """Each sparse request's product a·Hᵀ through spmm on the plan its
    wrapper chooses (one pass: b ≤ 256 rows fit L2) and on the L2-blocked
    scatter forced onto the same output (buckets of the most rows, a power
    of two, that b // 37 holds, as the card tests force it), checked
    against the plain version and timed in turns.  b = 1 has no bucketed
    plan: its one row is one bucket."""
    import torch
    from repro_torch.kernels import ops, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b, req, _ in reqs:
        idx = req._indices().to(torch.int32)
        v, r, c = req._values(), idx[0].contiguous(), idx[1].contiguous()
        nnz, size = v.numel(), Ht.element_size()
        chosen = ops.plan_spmm(nnz, b, K, size, sms)
        require(chosen.buckets == 1, f"served spmm b={b}: plan {chosen} is "
                                     f"not a single pass")
        shift = max(1, b // 37).bit_length() - 1
        buckets = -(-b // (1 << shift))

        def call(plan=None):
            return ops.spmm(v, r, c, Ht, b, plan=plan)
        if buckets == 1:
            t = time_ms(call, 50)
            log(f"[serve sparse] spmm b={b:4d} ({nnz} triplets) single pass "
                f"{t:.4f} ms; no bucketed plan: one row is one bucket")
            out[b] = {"plan_ms": t, "bucketed_ms": None}
            continue
        forced = ops.SpmmPlan(buckets, shift, ops.SPMM_BUCKET_RUN,
                              ops.SPMM_BUCKET_BLOCKS_PER_SM * sms,
                              nnz * (8 + size))
        _, err = scaled_err(call(forced), ref.spmm(v, r, c, Ht, b))
        require(err <= SERVE_TOL["product"],
                f"served spmm b={b} on {forced} disagrees with its plain "
                f"version: {err}")
        c1, f1, f2, c2 = (time_ms(f, 50) for f in (
            call, lambda: call(forced), lambda: call(forced), call))
        log(f"[serve sparse] spmm b={b:4d} ({nnz} triplets) single pass "
            f"{c1:.4f}/{c2:.4f} ms; forced {buckets} buckets (2^{shift} "
            f"rows, scratch {forced.scratch_bytes} B) {f1:.4f}/{f2:.4f} ms; "
            f"scaled err {err:.3e}")
        out[b] = {"plan_ms": min(c1, c2), "bucketed_ms": min(f1, f2),
                  "bucketed_buckets": buckets}
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
    from repro_torch.backends import SparseOps
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
    timings.update(phase_luc(dev, LUC_RAGGED + ((m, K),), errs, "video", m))
    launches, summary, res_bpp = phase_main(
        A, args.seed, (("bpp", 10), ("mu", 3), ("hals", 3)))
    counts, summary["accel"] = phase_accel(A, args.seed,
                                           (("amu", 3), ("ahals", 3)))
    add_launches(launches, counts)
    summary["breakdown_ms"] = phase_breakdown(
        A, args.seed, (("bpp", 2), ("mu", 3), ("hals", 3), ("amu", 3),
                       ("ahals", 3)))
    counts, summary["serve"] = phase_serve_dense(A, res_bpp)
    add_launches(launches, counts)
    del A, res_bpp
    torch.cuda.empty_cache()

    if args.sparse_dim != SPARSE_DIM:
        log(f"[data] cut: sparse m = n = {args.sparse_dim} of {SPARSE_DIM}")
    sp = phase_sparse_data(dev, args.seed, args.sparse_dim)
    phase_sparse_kernels(sp["blk"], errs)
    timings.update(phase_sparse_timings(sp["blk"], sp["srt"], errs))
    for name, row in phase_luc(dev, ((args.sparse_dim, K),), errs,
                               "webbase", args.sparse_dim).items():
        timings[name].update({f"{key}_sparse": v for key, v in row.items()})
    counts, sp_summary, res_mu = phase_sparse_main(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 3, "sorted"), ("mu", 3, "auto"), ("hals", 3, "sorted"),
         ("hals", 3, "auto"), ("bpp", 1, "sorted")))
    add_launches(launches, counts)
    counts, sp_summary["serve"] = phase_serve_sparse(res_mu, args.sparse_dim,
                                                     args.seed)
    add_launches(launches, counts)
    del res_mu
    torch.cuda.empty_cache()
    counts, sp_summary["accel"] = phase_accel(
        sp["srt"], args.seed, (("ahals", 2),),
        backend=SparseOps(spmm_impl="sorted"), label="sparse accel")
    add_launches(launches, counts)
    sp_summary["breakdown_ms"] = phase_sparse_breakdown(
        sp["blk"], sp["srt"], args.seed,
        (("mu", 2, "sorted"), ("mu", 2, "auto"), ("hals", 2, "sorted"),
         ("hals", 2, "auto"), ("amu", 2, "sorted"), ("ahals", 2, "sorted")))
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
