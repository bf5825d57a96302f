#!/usr/bin/env python3
"""chip_smoke.py's phase 37 alone, for a quick check on one card.

    python3 tools/chip_tp_rec_phase.py [--seed N]

Runs phase 37 (the recurrent mixers split over "model" on four gloo ranks
sharing the card: recurrentgemma-9b at full width, one period of its
layers, and xlstm-125m at full size, on (1, 4), each against the
unsharded run on the card, and each recurrent mixer alone in fp32 against
itself whole; then a wholesale-bf16 xlstm-125m tree served unsharded) as
chip_smoke.py runs it after phase 36.  It launches no
kernel of csrc/, so nothing is built.  Prints the phase's lines, then one
JSON object of its results.
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
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = cs.phase_card()
    out = cs.phase_tp_rec(torch.device("cuda", 0), args.seed, card)
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
