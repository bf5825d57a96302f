#!/usr/bin/env python3
"""Where the distributed schedules' peak device memory goes, against the
serial schedule's, on one NVIDIA GPU.

    python3 tools/probe_schedule_memory.py [--dense-n 2048] [--sparse-dim N]
                                           [--iters 2] [--algo mu]
                                           [--compressed]

For each matrix (a dense low-rank A with Video's 1,013,400 rows, and the
Webbase-density sparse A of chip_smoke.py at ``--sparse-dim``; 0 skips it)
it runs ``fit()``'s three parts (prepare, the iterations, collect) once
serially, once with ``schedule="faun"`` on a 1×1 grid of a one-rank NCCL
group and once with ``schedule="naive"`` on that group, with the caching
allocator's history recorded.  It replays the
history to the moment of the peak allocation and prints what was alive
then, summed by the line of the port (or of this script) that allocated
it, beside ``torch.cuda.max_memory_allocated``.  A tensor held past its
last use (by a collective's work, say) shows as an allocation site alive
at the peak that the schedule's code has already dropped.

``--compressed`` runs faun and naive with ``panel_compression="int8"``
as well (the residuals they keep and the quantiser's temporaries show by
the line of ``distributed/compression.py`` that made them).  ``--hold``
names a variant of faun's step to run as well (after the plain one): ``sync`` synchronises the card after every collective, so every
collective has finished before the next allocation.  Everything is made on
the device from ``--seed``.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

K = 50
VIDEO_M = 1_013_400


def site(frames) -> str:
    """The innermost frame of the port, this script or chip_smoke.py."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name or name.endswith(("probe_schedule_memory.py",
                                                   "chip_smoke.py")):
            short = name[name.find("repro_torch"):] if "repro_torch" in name \
                else os.path.basename(name)
            return f"{short}:{f.get('line')} {f.get('name')}"
    return "(outside the port)"


def replay(trace):
    """(peak bytes over the trace, live {addr: (size, site)} at the peak).
    An allocation counts from 'alloc' to 'free_requested', as
    ``max_memory_allocated`` counts it."""
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = (ev["size"], site(ev.get("frames", ())))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif (act in ("free_requested", "free_completed")
              and ev["addr"] in live):
            cur -= live.pop(ev["addr"])[0]
    return peak, at_peak


def run(A, seed: int, iters: int, algo: str, **solver_kw):
    import torch
    from repro_torch.core.engine import NMFSolver
    solver = NMFSolver(K, algo=algo, max_iters=iters, **solver_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    rs = solver.prepare_state(A, seed=seed)
    solver.run_segment(rs, iters)
    res = solver.collect_result(rs)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    trace = [ev for dev in snap["device_traces"] for ev in dev]
    t_peak, live = replay(trace)
    del rs, res
    torch.cuda.empty_cache()
    by_site = collections.defaultdict(lambda: [0, 0])
    for size, where in live.values():
        by_site[where][0] += size
        by_site[where][1] += 1
    return peak_gb, t_peak / 1e9, by_site


def show(label: str, out) -> None:
    peak_gb, t_peak, by_site = out
    print(f"[{label}] peak over the run {peak_gb:.3f} GB above what was "
          f"allocated before it (max_memory_allocated); replayed history: "
          f"{t_peak:.3f} GB; alive at the peak, by allocation site:",
          flush=True)
    for where, (size, count) in sorted(by_site.items(),
                                       key=lambda kv: -kv[1][0]):
        if size >= 1e6:
            print(f"    {size / 1e9:8.3f} GB  {count:3d} blocks  {where}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dense-n", type=int, default=2048)
    ap.add_argument("--sparse-dim", type=int, default=1 << 24)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--algo", default="mu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hold", choices=("sync",), default=None)
    ap.add_argument("--compressed", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist
    import chip_smoke
    from repro_torch.backends.sparse import SparseOps
    from repro_torch.core import faun
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.data.pipeline import lowrank_matrix
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TORCH_NCCL_AVOID_RECORD_STREAMS="
          f"{os.environ.get('TORCH_NCCL_AVOID_RECORD_STREAMS')}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grid = make_faun_grid(1, 1)
        for group in (None, grid.world, grid.row_group, grid.col_group):
            dist.all_reduce(torch.zeros(1, device=dev), group=group)
        cases = []
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        if args.dense_n:
            cases.append((f"dense {VIDEO_M}x{args.dense_n}",
                          lowrank_matrix(gen, VIDEO_M, args.dense_n, K,
                                         noise=0.5), {}))
        if args.sparse_dim:
            sp = chip_smoke.phase_sparse_data(dev, args.seed, args.sparse_dim)
            cases.append((f"sparse {args.sparse_dim}^2 sorted", sp["srt"],
                          {"backend": SparseOps(spmm_impl="sorted")}))
            del sp
        for label, A, kw in cases:
            t0 = time.perf_counter()
            show(f"{label} serial {args.algo}",
                 run(A, args.seed, args.iters, args.algo, **kw))
            show(f"{label} faun 1x1 {args.algo}",
                 run(A, args.seed, args.iters, args.algo, schedule="faun",
                     grid=grid, **kw))
            show(f"{label} naive p=1 {args.algo}",
                 run(A, args.seed, args.iters, args.algo, schedule="naive",
                     **kw))
            if args.compressed:
                show(f"{label} faun 1x1 {args.algo} int8",
                     run(A, args.seed, args.iters, args.algo,
                         schedule="faun", grid=grid,
                         panel_compression="int8", **kw))
                show(f"{label} naive p=1 {args.algo} int8",
                     run(A, args.seed, args.iters, args.algo,
                         schedule="naive", panel_compression="int8", **kw))
            if args.hold == "sync":
                saved = (faun.allgather_panel, faun.matmul_reducescatter)

                def synced(fn):
                    def call(*a, **k):
                        out = fn(*a, **k)
                        torch.cuda.synchronize()
                        return out
                    return call
                faun.allgather_panel, faun.matmul_reducescatter = (
                    synced(saved[0]), synced(saved[1]))
                try:
                    show(f"{label} faun 1x1 {args.algo}, synchronised after "
                         f"each collective",
                         run(A, args.seed, args.iters, args.algo,
                             schedule="faun", grid=grid, **kw))
                finally:
                    faun.allgather_panel, faun.matmul_reducescatter = saved
            print(f"[{label}] {time.perf_counter() - t0:.1f} s", flush=True)
            del A
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
