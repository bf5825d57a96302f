#!/usr/bin/env python3
"""What chip_smoke.py's phase 15g reads on sound and on faulty grids, to
place its limit between them, on one NVIDIA GPU.

    python3 tools/probe_grid_tolerance.py [--seeds 0 1 2 3 4]
                                          [--faults bf16 swap]

Phase 15g runs ``faun`` on a 2×2 grid of four gloo ranks sharing the card
(m = 253,344 of Video's rows, n = 13,824, k = 50; mu and hals, 3
iterations each) and holds W and H against a float64 fit from the same
seed: the grid's scaled distance to it against the serial fp32 fit's.
This script runs that phase (``chip_smoke.phase_grid`` without its
checks) once for each of ``--seeds`` on a sound grid, then for each of
``--faults`` on the first seed with a fault injected into every rank's
iterations (never into ``collect``):

  bf16   every gathered factor panel rounded to bf16, as if panel_dtype
         had been set without being asked for;
  swap   every gathered panel's blocks in reversed group-rank order.

For each run it prints, per rule and factor, the grid's and the serial
fit's scaled distance to the float64 fit, their ratio, and the largest
relative difference of the rel errors from the serial fit's.  Everything
is made on the device from the seed.  Exits 1 without a CUDA device.
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


def faulty_rank(fault: str, box: list, out: str, seed: int, runs) -> None:
    """chip_smoke.grid_rank with ``fault`` in every gathered panel of the
    iterations (``faun_iteration`` looks ``allgather_panel`` up when it
    runs; ``collect`` gathers through the sound one)."""
    import torch.distributed as dist
    import chip_smoke
    from repro_torch.core import faun
    gather, iteration = faun.allgather_panel, faun.faun_iteration
    inside = [False]

    def bad_gather(x, group):
        g = gather(x, group)
        if not inside[0]:
            return g
        if fault == "bf16":
            return g.bfloat16().to(g.dtype)
        size = dist.get_world_size(group)
        return g.view(size, -1, g.shape[-1]).flip(0).reshape(g.shape)

    def bad_iteration(*args, **kwargs):
        inside[0] = True
        try:
            return iteration(*args, **kwargs)
        finally:
            inside[0] = False

    faun.allgather_panel, faun.faun_iteration = bad_gather, bad_iteration
    chip_smoke.grid_rank(box, out, seed, runs)


def report(label: str, summary: dict) -> None:
    import numpy as np
    for algo, _ in RUNS:
        row = summary[algo]
        rels = np.asarray(row["rel_errors"])
        s_rels = np.asarray(row["serial_rel_errors"])
        rel_diff = float(np.max(np.abs(rels - s_rels) / s_rels))
        r64 = np.asarray(row["float64_rel_errors"])
        g64 = float(np.max(np.abs(rels - r64) / r64))
        s64 = float(np.max(np.abs(s_rels - r64) / r64))
        print(f"[{label}] {algo:4s} rel errors' largest relative distance "
              f"to the float64 fit's: grid {g64:.4e}, serial {s64:.4e}, "
              f"ratio {g64 / s64:.4f}", flush=True)
        for f, e in row["scaled_err"].items():
            ratio = e["grid-float64"] / e["serial-float64"]
            print(f"[{label}] {algo:4s} {f}: grid-float64 "
                  f"{e['grid-float64']:.4e}, serial-float64 "
                  f"{e['serial-float64']:.4e}, ratio {ratio:.4f}, "
                  f"grid-serial {e['grid-serial']:.4e}; rel errors' largest "
                  f"relative difference {rel_diff:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--faults", nargs="*", default=["bf16", "swap"],
                    choices=["bf16", "swap"])
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
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        report(f"sound seed {seed}",
               chip_smoke.phase_grid(dev, seed, RUNS, card, check=False))
    for fault in args.faults:
        report(f"fault {fault} seed {args.seeds[0]}",
               chip_smoke.phase_grid(
                   dev, args.seeds[0], RUNS, card, check=False,
                   rank_fn=functools.partial(faulty_rank, fault)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
