#!/usr/bin/env python3
"""chip_smoke.py's training phases alone, for a quick check on one card.

    python3 tools/chip_train_phases.py [--seed N]

Runs phases 29 (every architecture's reduced config trained on the card,
its gradients against the CPU port's), 30 (smollm-135m at full size:
steps, microbatches, the fp32 twin, the resumed loop), 31 (dbrx-132b at
full width, one layer, Adafactor) and 32 (the sharded step and moe_ep on
a one-rank NCCL mesh) as chip_smoke.py runs them after phase 28.  They
launch no kernel of csrc/, so nothing is built.  Prints each phase's
lines, then one JSON object of their results.
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
    out = cs.phase_train(torch.device("cuda", 0), args.seed)
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
