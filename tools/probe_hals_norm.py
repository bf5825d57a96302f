#!/usr/bin/env python3
"""The HALS W-step's normalised sweep on one NVIDIA GPU: the
``hals_sweep_norm`` kernel against the plain column loop it replaced
(``kernels/ref.hals_sweep_norm``), at the benchmark's Webbase-density
factor (2^24 × 50) and at Video's W (1,013,400 × 50).

    python3 tools/probe_hals_norm.py [--shapes 16777216x50 1013400x50]
                                     [--reps 10] [--seed 0] [--passes]

For each shape (fp32): X, G and R as a W-step meets them (X near a planted
X*, R = X*·G plus noise, G = CᵀC); the kernel's and the loop's ms a sweep
(CUDA events over ``--reps`` sweeps after a warm-up), the bound (R, X and
G read once and X written once at 3.35 TB/s), the kernel's launches a
sweep, the device memory each allocates above the inputs, and the largest
column-scaled distance between the two results; with ``--passes``, the
device ms a sweep of each of the kernel's passes (head, column, tail) by
``torch.profiler``.  Prints one JSON line per shape.  Exits 1 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12


def inputs(r: int, k: int, seed: int, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    C = torch.rand((30, k), generator=gen, device=dev)
    G = C.T @ C
    R = torch.empty((r, k), device=dev)
    X = torch.empty((r, k), device=dev)
    step = 1 << 20
    for r0 in range(0, r, step):             # X* a chunk at a time
        Xs = torch.rand((min(step, r - r0), k), generator=gen, device=dev)
        R[r0:r0 + step] = Xs @ G + 0.1 * torch.rand(Xs.shape, generator=gen,
                                                    device=dev)
        X[r0:r0 + step] = Xs * (0.5 + torch.rand(Xs.shape, generator=gen,
                                                 device=dev))
    return X, G, R


def timed(fn, reps: int):
    import torch
    fn()                                     # warm-up (and the build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def extra_memory(fn):
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    del out
    return extra


def pass_ms(fn, reps: int) -> dict:
    """Device ms a call of each kernel that ``fn`` launches, by name."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or 0
        if us and "norm_" in ev.key:
            name = ev.key.split("norm_")[1].split("_kernel")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+",
                    default=["16777216x50", "1013400x50"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--passes", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("probe_hals_norm: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.rules import eps_for
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(dev)
    for shape in args.shapes:
        r, k = (int(v) for v in shape.split("x"))
        X, G, R = inputs(r, k, args.seed, dev)
        eps = eps_for(X.dtype)

        def kernel():
            return ops.hals_sweep_norm(X, G, R, eps=eps)

        def plain():
            return ref.hals_sweep_norm(X, G, R, eps)

        ops.reset_launches()
        kernel()
        launches = ops.LAUNCHES["hals_sweep_norm"]
        k_ms, got = timed(kernel, args.reps)
        p_ms, want = timed(plain, max(1, args.reps // 5))
        scale = want.abs().amax(0).clamp_min(1e-30)
        err = ((got - want).abs().amax(0) / scale).max().item()
        same = bool(torch.equal(got, kernel()))
        del got, want
        k_mem, p_mem = extra_memory(kernel), extra_memory(plain)
        bound = 4.0 * (3 * r * k + k * k) / HBM_BYTES_PER_S * 1e3
        passes = pass_ms(kernel, 3) if args.passes else None
        print(json.dumps({
            "shape": [r, k], "card": card, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound,
            "roofline_pct": 100.0 * bound / k_ms,
            "launches_a_sweep": launches,
            "kernel_extra_gb": k_mem / 1e9, "plain_extra_gb": p_mem / 1e9,
            "max_column_scaled_err": err, "repeat_bit_equal": same,
            "pass_ms_a_sweep": passes}),
            flush=True)
        del X, G, R
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
