#!/usr/bin/env python3
"""chip_smoke.py's counting phases alone, for a quick check on one card.

    python3 tools/chip_dryrun_phases.py [--seed N] [--m M] [--only 35]

Runs phase 33 (mu and hals counted on fake tensors of Video's shape
against a live iteration on the card: kernel calls, the roofline bound
against the measured ms; faun 1×1's collectives on a one-rank NCCL group
against the live wire log; smollm-135m's prefill and train step counted
beside their measured ms), 34 (the dry run as subprocesses: the five NMF
cells and smollm-135m × train_4k on the 16×16 mesh) and 35 (the GPipe
pipeline on four gloo ranks sharing the card) as chip_smoke.py runs them.
It builds the kernels and makes its own Video A (56 GB at full height;
``--m`` cuts it).  ``--only`` runs the named phases alone (33, 34, 35).
Prints each phase's lines, then one JSON object of their results.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=None,
                    help="rows of A (default: Video's)")
    ap.add_argument("--only", nargs="*", default=["33", "34", "35"],
                    help="the phases to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.data.pipeline import lowrank_matrix
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.phase_card()
    dev = torch.device("cuda", 0)
    out = {}
    if "33" in args.only:
        cs.phase_build()
        m = args.m or cs.M_FULL
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        A = lowrank_matrix(gen, m, cs.N_FULL, cs.K, noise=cs.NOISE)
        _, out["count_nmf"] = cs.phase_count_nmf(A, args.seed, card)
        del A
        torch.cuda.empty_cache()
        out["count_models"] = cs.phase_count_models(dev, args.seed, card)
    if "34" in args.only:
        out["dryrun"] = cs.phase_dryrun(card)
    if "35" in args.only:
        out["pipeline"] = cs.phase_pipeline(dev, card)
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
