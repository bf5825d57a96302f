#!/usr/bin/env python3
"""chip_smoke.py's model-stack phases alone, for a quick check on one card.

    python3 tools/chip_model_phases.py [--seed N]

Builds the kernels, then runs phases 26 (every architecture reduced), 27
(smollm-135m at full size, four more architectures at full width) and 28
(the NMF compression of smollm-135m's FFN weights) and the profiled decode
step, as chip_smoke.py runs them after its earlier phases (≈ 70 s with the
build instead of the whole script's ≈ 7 min).  Prints each phase's lines,
then one JSON object of their results.
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
    cs.phase_build()
    dev = torch.device("cuda", 0)
    out, errs = {}, {}
    out["models"] = cs.phase_models_reduced(dev, args.seed)
    model, out["smollm"] = cs.phase_smollm(dev, args.seed)
    out["full_width"] = cs.phase_full_width(dev, args.seed)
    out["launches"], out["compress"], out["kernels"] = \
        cs.phase_weight_compress(model, args.seed, errs)
    del model
    torch.cuda.empty_cache()
    out["smollm"].update(cs.phase_decode_profile(
        dev, args.seed, out["smollm"]["decode_ms_per_step"][-1]))
    out["errs"] = errs
    print(json.dumps(out, default=str))
    print(f"total {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
