"""The benchmark's own launcher: one process per card, joined over NCCL.

``ranks(p, fn, args)`` starts ``p`` processes (``torch.multiprocessing``,
spawned), each rank r on card r (``cuda:r``; gloo on the CPU for the
tests), in one process group over a file store in a temporary directory,
and runs ``fn(device, *args)`` on every rank.  After ``fn`` returns, each
rank checks that no module of ``FORBIDDEN`` is loaded in it.  Rank 0's
return value, which must be JSON, is the call's.

A rank that raises or exits, or ranks that have not all ended within
``timeout_s``, end the call: every rank still running is stopped and
waited for, what happened goes to standard error, and the call returns
None.  It never hangs.  The launcher is the benchmark's, not the
program's (``repro_torch.util.dist``), so a change to the program cannot
change how the benchmark starts its ranks.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: seconds the ranks have to end, their collectives' timeout too: under the
#: 1,200 s a checkout's first run may take (a later run has 360 s, and
#: the caller's own limit ends it first)
TIMEOUT_S = 1140.0


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _rank(rank: int, p: int, store: str, fn, args: tuple, device_type: str,
          timeout_s: float) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // p))
    if device_type == "cuda":
        device, backend = torch.device("cuda", rank), "nccl"
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=p,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        value = fn(device, *args)
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"rank {rank}: modules loaded that the port "
                               f"must not load: {found}")
        if rank == 0:
            out = Path(store).with_name("result.json")
            out.with_suffix(".tmp").write_text(json.dumps(value))
            os.replace(out.with_suffix(".tmp"), out)
    finally:
        dist.destroy_process_group()


def _stop(processes) -> None:
    """Every process still running ended, and all waited for."""
    for proc in processes:
        if proc.is_alive():
            proc.terminate()
    for proc in processes:
        proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()


def ranks(p: int, fn, args: tuple = (), *, device_type: str = "cuda",
          timeout_s: float = TIMEOUT_S):
    """Rank 0's ``fn(device, *args)`` of ``p`` ranks, or None where a rank
    failed or time ran out (see the module's docstring).  ``fn`` is a
    top-level function: it is pickled."""
    with tempfile.TemporaryDirectory(prefix="perfbench_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank, args=(p, os.path.join(tmp, "store"), fn, args,
                         device_type, timeout_s),
            nprocs=p, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    print(f"perfbench: the {p} ranks did not end within "
                          f"{timeout_s:.0f} s", file=sys.stderr)
                    return None
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            print(f"perfbench: a rank failed: {e}", file=sys.stderr)
            return None
        finally:
            _stop(ctx.processes)
        return json.loads(Path(tmp, "result.json").read_text())


def run_cell(device: torch.device, root: str, name: str, seed: int,
             seconds: float, trace: bool, t_start: float) -> dict:
    """``harness.run`` on one rank (a ``ranks`` target)."""
    import harness
    return harness.run(Path(root), name, seed, seconds, trace, device,
                       t_start)
