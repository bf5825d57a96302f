"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It runs ``repro_torch`` (the PyTorch and
CUDA port, from ``src``) on the CUDA device and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, with ``--trace 1``, ``breakdown``; the
numbers compared against the plain reference come last, under
``checks``, and again as the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, or with ``jax``,
``jaxlib``, ``flax`` or the JAX package loaded once the window has
closed, it prints no result and exits with 2.

A serial one-chip cell runs in this process.  A ranked cell (more chips,
or another schedule) runs on one process per card that ``launch`` starts;
this process prints rank 0's result, and exits with 1 and no result where
a rank fails or the ranks do not end in time.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from launch import forbidden_modules  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    cell = harness.Cell(ROOT, args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    if cell.ranked:
        import launch
        result = launch.ranks(chips, launch.run_cell,
                              (str(ROOT), args.workload, args.seed,
                               args.seconds, bool(args.trace), T_START))
        if result is None:
            return 1
    else:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
