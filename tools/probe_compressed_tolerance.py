#!/usr/bin/env python3
"""What chip_smoke.py's int8 checks (phase 17 and phase 15g's int8 runs)
read on sound and on faulty wires, to place their limits between them, on
one NVIDIA GPU.

    python3 tools/probe_compressed_tolerance.py [--seeds 0 1 2 3 4]
        [--faults nofeedback rowslice] [--parts one grid] [--m 1013400]

Both checks hold an int8 fit by its direct ||A − WH|| / ||A|| against the
exact fit's from the same seed (``chip_smoke.COMPRESSED_DIRECT_TOL``).
For each of ``--seeds`` on a sound wire, then for each of ``--faults`` on
every seed, this script prints that gap (int8 minus exact) for mu and
hals, 3 iterations each:

  one   faun 1×1 on a one-rank NCCL group at Video's shape (``--m`` ×
        13,824, k = 50; phase 17's runs), A made on the card from the
        seed;
  grid  phase 15g's 2×2 grid of four gloo ranks sharing the card (m =
        253,344; ``chip_smoke.phase_grid`` without its checks), the fault
        planted in every rank.

Faults, planted in ``Int8PanelCompressor`` for the int8 fits only:

  nofeedback  every quantisation starts from a zero residual (the error
              feedback dropped; the residuals are still returned);
  rowslice    the reduce-scatter dequantises each row with the scale of
              the row before it in its slice (a wrong row-scale slice).

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RUNS = (("mu", 3), ("hals", 3))
FAULTS = ("nofeedback", "rowslice")


def plant(fault: str | None) -> None:
    """Plant ``fault`` into ``Int8PanelCompressor`` in this process."""
    if fault is None:
        return
    import torch
    from repro_torch.distributed import compression
    cls = compression.Int8PanelCompressor
    if fault == "nofeedback":
        quantize = cls._ef_quantize

        def no_feedback(self, x, residual, **kwargs):
            return quantize(self, x, torch.zeros_like(residual), **kwargs)

        cls._ef_quantize = no_feedback
    elif fault == "rowslice":
        scatter, rescale = cls.reduce_scatter, compression._rescale

        def wrong_slice(self, x, group, residual):
            compression._rescale = lambda q, rs, cs: rescale(
                q, torch.roll(rs, 1), cs)
            try:
                return scatter(self, x, group, residual)
            finally:
                compression._rescale = rescale

        cls.reduce_scatter = wrong_slice
    else:
        raise ValueError(f"unknown fault {fault!r}")


def faulty_rank(fault, box, out, seed, runs, compressed=()):
    """chip_smoke.grid_rank with ``fault`` planted in the rank."""
    import chip_smoke
    plant(fault)
    chip_smoke.grid_rank(box, out, seed, runs, compressed)


def one_rank(seeds, faults, m: int, card: str) -> None:
    """faun 1×1 exact and int8 at ``m`` × 13,824 for each seed, sound and
    with each fault."""
    import torch
    import chip_smoke
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.data.pipeline import lowrank_matrix
    from repro_torch.distributed import compression
    dev = torch.device("cuda", 0)
    cls = compression.Int8PanelCompressor
    sound = (cls._ef_quantize, cls.reduce_scatter)
    with chip_smoke.nccl_group():
        grid = make_faun_grid(1, 1)
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            A = lowrank_matrix(gen, m, chip_smoke.N_FULL, chip_smoke.K,
                               noise=chip_smoke.NOISE)
            for algo, iters in RUNS:
                def direct(comp):
                    res = NMFSolver(chip_smoke.K, algo=algo, schedule="faun",
                                    grid=grid, max_iters=iters,
                                    panel_compression=comp).fit(A, seed=seed)
                    return chip_smoke.direct_rel_error(A, res.W, res.H)
                exact = direct(None)
                for fault in (None,) + tuple(faults):
                    plant(fault)
                    try:
                        gap = direct("int8") - exact
                    finally:
                        cls._ef_quantize, cls.reduce_scatter = sound
                    print(f"[one {fault or 'sound'} seed {seed}] {algo:4s} "
                          f"{(m, chip_smoke.N_FULL, chip_smoke.K)}: int8 "
                          f"direct rel error − exact {gap:+.4e} (exact "
                          f"{exact:.6f}); card {card}", flush=True)
            del A
            torch.cuda.empty_cache()


def on_grid(seeds, faults, card: str) -> None:
    """Phase 15g's grid, exact and int8, for each seed, sound and with
    each fault planted in the ranks."""
    import torch
    import chip_smoke
    dev = torch.device("cuda", 0)
    for seed in seeds:
        for fault in (None,) + tuple(faults):
            summary = chip_smoke.phase_grid(
                dev, seed, RUNS, card, check=False, compressed=RUNS,
                rank_fn=(chip_smoke.grid_rank if fault is None else
                         functools.partial(faulty_rank, fault)))
            for algo, _ in RUNS:
                row = summary[f"{algo}_int8"]
                gap = row["direct_rel_error"] - row["exact_direct_rel_error"]
                print(f"[grid {fault or 'sound'} seed {seed}] {algo:4s} "
                      f"2×2 m = {chip_smoke.GRID_M}: int8 direct rel error − "
                      f"exact grid's {gap:+.4e} (exact "
                      f"{row['exact_direct_rel_error']:.6f}); card {card}",
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--faults", nargs="*", default=list(FAULTS),
                    choices=FAULTS)
    ap.add_argument("--parts", nargs="+", default=["one", "grid"],
                    choices=["one", "grid"])
    ap.add_argument("--m", type=int, default=None,
                    help="rows of the one-rank part's A (Video's by default)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "one" in args.parts:
        one_rank(args.seeds, args.faults, args.m or chip_smoke.M_FULL, card)
    if "grid" in args.parts:
        on_grid(args.seeds, args.faults, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
