#!/usr/bin/env python3
"""chip_smoke.py's phase 38 alone, for a quick check on one card.

    python3 tools/chip_tp_heads_phase.py [--seed N]

Runs phase 38 (attention and the xLSTM cells on each rank's whole heads
where the heads do not divide "model", on three gloo ranks sharing the
card: yi-34b at full width, 2 of its 60 layers, whisper-base and
xlstm-125m at full size, on (1, 3), each against the unsharded run on the
card, and each uneven layer alone in fp32 against itself whole) as
chip_smoke.py runs it after phase 37.  It launches no kernel of csrc/, so
nothing is built.  Prints the phase's lines, then one JSON object of its
results.
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
    out = cs.phase_tp_heads(torch.device("cuda", 0), args.seed, card)
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
