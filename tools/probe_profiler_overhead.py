#!/usr/bin/env python3
"""Does a ``torch.profiler`` session leave host cost behind on the card?

    python3 tools/probe_profiler_overhead.py     # one CUDA device

Times a loop of tiny launches (``x.add_(1.0)`` on 16 floats) and a loop of
launch + host sync, before and after one profiler session with CPU and
CUDA activities, and prints microseconds per launch for each, the kernels
the session saw, and the card's name and power limit.  chip_smoke.py runs
its decode profile last because of what this reads (PERF.md §7).
"""

import subprocess
import sys
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    x = torch.zeros(16, device="cuda")

    def launches(n=20_000):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    def synced(n=2_000):
        t = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
            x.sum().item()
        return (time.perf_counter() - t) / n * 1e6

    launches()
    print(f"before: {launches():.2f} / {launches():.2f} us a launch, "
          f"{synced():.2f} us a launch + sync", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            x.add_(1.0)
        torch.cuda.synchronize()
    seen = sum(1 for e in prof.events()
               if str(e.device_type).endswith("CUDA"))
    print(f"profiled: {seen} kernels seen")
    print(f"after:  {launches():.2f} / {launches():.2f} us a launch, "
          f"{synced():.2f} us a launch + sync", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
