#!/usr/bin/env python3
"""Bytes each rank receives per iteration, schedule by schedule, on a 2×2
grid of gloo ranks on the CPU, beside the cost model's words.

    PYTHONPATH=src python3 tools/probe_wire_bytes.py [--shapes 96,64,6 \
        8192,4096,16] [--density 0.25]

For each shape (m, n, k) it runs one iteration (after one to warm up) of:
faun exact and int8, naive (4 ranks) exact and int8, gspmd on the dense
backend exact and int8, and gspmd on the sparse backend (A kept at
``--density``), all mu, recording every collective of the iteration on
every rank (``repro_torch.util.wire.record_wire``).  It prints, per run,
the largest bytes any rank received beside 4 × ``predict_cost(m, n).words``
(the α-β-γ model's words are fp32 words; for gspmd the model prices the
faun schedule, its optimum), the collectives by op and dtype, and for
gspmd which part of the iteration issued them (the products, the Grams,
the two rule updates, the emulated quantiser and the error), with each
collective's shape, so a redistribution of A shows.

Counts of an optimal collective (``util/wire.py``), not times: gloo ranks
on the CPU.  Writes its result as JSON to ``--out`` (default stdout only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

RUNS = (("faun", None, "dense"), ("faun", "int8", "dense"),
        ("naive", None, "dense"), ("naive", "int8", "dense"),
        ("gspmd", None, "dense"), ("gspmd", "int8", "dense"),
        ("gspmd", None, "sparse"))


def _problem(m, n, k, density):
    import numpy as np
    rng = np.random.default_rng(0)
    A = (rng.uniform(size=(m, k)).astype(np.float32)
         @ rng.uniform(size=(k, n)).astype(np.float32)
         + 0.5 * rng.uniform(size=(m, n)).astype(np.float32))
    As = A.copy()
    As[rng.uniform(size=A.shape) >= density] = 0.0
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, As, W0, H0


def _attribute(solver, log, spans):
    """Wrap the gspmd iteration's parts so each collective is charged to
    the part that issued it."""
    from repro_torch.core import gspmd

    def wrap(label, fn):
        def run(*args, **kwargs):
            start = len(log)
            out = fn(*args, **kwargs)
            spans.append((label, start, len(log)))
            return out
        return run

    ops = solver._schedule.ops
    ops.mm = wrap("mm A·Hᵀ", ops.mm)
    ops.mm_t = wrap("mm_t AᵀW", ops.mm_t)
    ops.gram = wrap("gram", ops.gram)
    if solver.compress is not None:
        c = solver.compress
        c.simulate = wrap("quantiser", c.simulate)
        c.simulate_gram = wrap("quantiser", c.simulate_gram)
    saved = gspmd.sq_error_from_products, gspmd.rule_on_rows

    def on_rows(update, *args):     # the rule and its operands' layout
        return wrap(update.__name__, saved[1])(update, *args)

    gspmd.sq_error_from_products = wrap("error", saved[0])
    gspmd.rule_on_rows = on_rows

    def restore():
        gspmd.sq_error_from_products, gspmd.rule_on_rows = saved

    return restore


def _rank(out, shapes, density):
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.util.wire import record_wire
    grid = make_faun_grid(2, 2)
    rows = []
    for m, n, k in shapes:
        A, As, W0, H0 = _problem(m, n, k, density)
        nnz = int(np.count_nonzero(As))
        for schedule, comp, backend in RUNS:
            kw = dict(grid=grid) if schedule != "naive" else {}
            solver = NMFSolver(k, algo="mu", schedule=schedule,
                               backend=backend, panel_compression=comp,
                               device="cpu", **kw)
            data = As if backend == "sparse" else A
            rs = solver.prepare_state(data, W0=W0, H0=H0)
            solver.run_segment(rs, 1)
            spans, restore = [], None
            with record_wire() as log:
                if schedule == "gspmd":
                    restore = _attribute(solver, log, spans)
                solver.run_segment(rs, 1)
            if restore:
                restore()
            by_part = {}
            covered = set()
            for label, a, b in spans:
                for i in range(a, b):
                    if i in covered:
                        continue
                    covered.add(i)
                    c = log[i]
                    part = by_part.setdefault(label, {})
                    key = f"{c.op} {str(c.dtype)[6:]} {list(c.shape)}"
                    part[key] = part.get(key, 0) + c.received
            if schedule == "gspmd":
                for i, c in enumerate(log):
                    if i not in covered:
                        part = by_part.setdefault("other", {})
                        key = f"{c.op} {str(c.dtype)[6:]} {list(c.shape)}"
                        part[key] = part.get(key, 0) + c.received
            kinds = {}
            for c in log:
                key = f"{c.op} {str(c.dtype)[6:]}"
                kinds[key] = kinds.get(key, 0) + c.received
            words = solver.predict_cost(
                m, n, nnz=float(nnz if backend == "sparse" else 0)).words
            rows.append({"shape": [m, n, k], "schedule": schedule,
                         "compression": comp, "backend": backend,
                         "received": log.received_bytes(),
                         "model_bytes": 4 * words, "by_kind": kinds,
                         "by_part": by_part, "nnz": nnz,
                         "A_block_bytes": (m // 2) * (n // 2) * 4})
    with open(os.path.join(out, f"wire_r{dist.get_rank()}.json"), "w") as f:
        json.dump(rows, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["96,64,6",
                                                     "8192,4096,16"])
    ap.add_argument("--density", type=float, default=0.25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split(",")) for s in args.shapes]
    from repro_torch.util import dist as rdist
    with tempfile.TemporaryDirectory(prefix="probe_wire_") as out:
        rdist.spawn(_rank, 4, out, shapes, args.density, backend="gloo",
                    device="cpu")
        ranks = []
        for r in range(4):
            with open(os.path.join(out, f"wire_r{r}.json")) as f:
                ranks.append(json.load(f))
    result = []
    for i, row in enumerate(ranks[0]):
        got = [rk[i]["received"] for rk in ranks]
        row = dict(row, received_per_rank=got, received=max(got))
        result.append(row)
        m, n, k = row["shape"]
        print(f"{m}×{n}, k={k}  {row['schedule']:5s} "
              f"{str(row['compression']):4s} {row['backend']:6s}: "
              f"{max(got):>12,.0f} B received (ranks {got}), model "
              f"{row['model_bytes']:>12,.0f} B")
        for key, b in sorted(row["by_kind"].items()):
            print(f"      {key:28s} {b:>12,.0f} B")
        for part, entries in row["by_part"].items():
            for key, b in sorted(entries.items()):
                print(f"      [{part}] {key:40s} {b:>12,.0f} B")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
