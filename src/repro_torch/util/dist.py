"""Start and join ranks of a ``torch.distributed`` job.  The port's side of
``repro/util/env.py``'s ``force_host_device_count``: the JAX package fakes
N host devices in one process, the port runs N processes.

    from repro_torch.util import dist as rdist

    def body(path):                      # a top-level function: it is pickled
        grid = make_faun_grid(2, 2)
        ...

    rdist.spawn(body, 4, "/tmp/out")     # 4 NCCL ranks, one card each
    rdist.spawn(body, 4, "/tmp/out", device="cpu")    # 4 gloo ranks

``spawn`` starts the ranks through ``torch.multiprocessing.spawn`` with a
``file://`` rendezvous in a fresh temporary directory (no TCP port, so
concurrent jobs on one host never collide).  Under ``torchrun`` each rank
calls ``init_from_env()`` instead, and ``one_rank_group`` makes the
calling process a one-rank group of its own (the distributed schedules at
p = 1, without a second process).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda`` → the rank's own card (``cuda:<local_rank>``); ``cuda:N`` →
    card N for every rank; ``cpu`` → the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank if dev.index is None
                           else dev.index)
        torch.cuda.set_device(dev)
    return dev


def _entry(local_rank: int, fn, nprocs: int, init_method: str, backend: str,
           device: str, args: tuple) -> None:
    torch.set_num_threads(1)
    _rank_device(device, local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            rank=local_rank, world_size=nprocs)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str | None = None,
          device: str = "cuda") -> None:
    """Run ``fn(*args)`` on ``nprocs`` ranks of one process group and wait
    for them all.  Each rank runs one thread, sets its card where
    ``device`` is CUDA (``cuda``, the default: card = rank; ``cuda:N``:
    card N), joins the group and destroys it when ``fn`` returns or
    raises.  ``backend`` None takes NCCL on CUDA and gloo on the CPU
    (``device="cpu"``); CUDA without a card raises.  A rank's exception
    fails the call (``torch.multiprocessing.spawn``'s join raises it in
    the parent).  ``fn`` and ``args`` are pickled: ``fn`` must be a
    top-level function."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "spawn was asked for CUDA ranks (its default) but "
            "torch.cuda.is_available() is false; pass device='cpu' for "
            "gloo ranks on the CPU")
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_rdv_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_entry, args=(fn, nprocs, init, backend, device, args),
                 nprocs=nprocs, join=True)


def init_from_env(device: str | None = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment).  ``device`` "cuda" (or "cuda:N") joins over NCCL on the
    rank's card and raises without one; "cpu" joins over gloo; None takes
    NCCL where CUDA is available, else gloo on the CPU.  Returns the
    rank's device; the caller destroys the group
    (``torch.distributed.destroy_process_group``) when done."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            f"init_from_env was asked for {device} but "
            "torch.cuda.is_available() is false; pass device='cpu' for a "
            "gloo rank on the CPU")
    dev = _rank_device(device, int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    return dev


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """The calling process as the only rank of the default process group
    for the ``with`` block: NCCL on a CUDA ``device``, gloo on the CPU,
    over an in-memory store; destroyed on exit.  Raises if a default group
    already exists."""
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
