"""Record what a rank puts on the wire: every collective's op, dtype, shape
and the bytes the rank receives for it.

    from repro_torch.util.wire import record_wire

    with record_wire() as log:
        solver.run_segment(rs, 1)
    log.received_bytes()          # this rank, that iteration
    {(c.op, c.dtype) for c in log}

Two routes are covered: the ``torch.distributed`` module functions the
hand-written schedules call (``all_reduce``, ``all_gather_into_tensor``,
``all_to_all_single``, ``reduce_scatter_tensor``, ``all_gather``,
``broadcast``; wrapped while the context is open), and the functional
collectives DTensor issues when it redistributes (``_c10d_functional``
ops, seen through a dispatch mode).

``record_wire(communicate=False)`` records the same entries and sends
nothing: each collective returns at once and leaves its output as it was
(``roofline.counts`` answers a step run on fake tensors this way).  The
log keeps each entry's group as its global ranks in ``log.ranks``.

Bytes received count an optimal collective on g ranks (paper §2.3, as
``core.costmodel.Machine.collective_words``): an all-gather (g−1)/g of its
output, a reduce-scatter and an all-to-all (g−1)/g of their input, an
all-reduce 2(g−1)/g of its tensor, a broadcast its tensor once.  An
all-to-all given its split sizes counts the output rows it receives from
the other ranks (the pipeline's hop: its whole tensor).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Collective:
    op: str                 # "all_reduce", "all_gather", "reduce_scatter",
    dtype: torch.dtype      # "all_to_all", "broadcast"
    shape: tuple            # of the tensor the rank sends (all_gather: its
    group_size: int         # own share)
    received: float         # bytes this rank receives


class WireLog(list):
    """The collectives recorded, in issue order; ``ranks[i]`` is entry i's
    group as global ranks."""

    def __init__(self):
        super().__init__()
        self.ranks: list[tuple] = []

    def add(self, entry: Collective, group) -> None:
        self.append(entry)
        self.ranks.append(_ranks(group))

    def received_bytes(self) -> float:
        return sum(c.received for c in self)


def _frac(g: int) -> float:
    return (g - 1) / g if g > 1 else 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _entry(op: str, t: torch.Tensor, g: int) -> Collective:
    n = _nbytes(t)
    received = {"all_reduce": 2 * _frac(g) * n,
                "all_gather": _frac(g) * n * g,
                "reduce_scatter": _frac(g) * n,
                "all_to_all": _frac(g) * n,
                "broadcast": float(n) if g > 1 else 0.0}[op]
    return Collective(op, t.dtype, tuple(t.shape), g, received)


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _c10d_wrappers(log: WireLog, communicate: bool = True) -> dict:
    def issue(name, args, kw):
        if communicate:
            return saved[name](*args, **kw)
        return None

    def all_reduce(tensor, *args, group=None, **kw):
        log.add(_entry("all_reduce", tensor, _group_size(group)), group)
        return issue("all_reduce", (tensor, *args), dict(kw, group=group))

    def all_gather_into_tensor(out, inp, *args, group=None, **kw):
        log.add(_entry("all_gather", inp, _group_size(group)), group)
        return issue("all_gather_into_tensor", (out, inp, *args),
                     dict(kw, group=group))

    def all_gather(out_list, tensor, *args, group=None, **kw):
        log.add(_entry("all_gather", tensor, _group_size(group)), group)
        return issue("all_gather", (out_list, tensor, *args),
                     dict(kw, group=group))

    def all_to_all_single(out, inp, *args, group=None, **kw):
        entry = _entry("all_to_all", inp, _group_size(group))
        splits = args[0] if args else kw.get("output_split_sizes")
        if splits is not None:
            me = dist.get_rank(group)
            rows = sum(s for j, s in enumerate(splits) if j != me)
            row = _nbytes(out) // out.shape[0] if out.shape[0] else 0
            entry = replace(entry, received=float(rows * row))
        log.add(entry, group)
        return issue("all_to_all_single", (out, inp, *args),
                     dict(kw, group=group))

    def reduce_scatter_tensor(out, inp, *args, group=None, **kw):
        log.add(_entry("reduce_scatter", inp, _group_size(group)), group)
        return issue("reduce_scatter_tensor", (out, inp, *args),
                     dict(kw, group=group))

    def broadcast(tensor, *args, group=None, **kw):
        log.add(_entry("broadcast", tensor, _group_size(group)), group)
        return issue("broadcast", (tensor, *args), dict(kw, group=group))

    wrappers = dict(all_reduce=all_reduce,
                    all_gather_into_tensor=all_gather_into_tensor,
                    all_gather=all_gather, all_to_all_single=all_to_all_single,
                    reduce_scatter_tensor=reduce_scatter_tensor,
                    broadcast=broadcast)
    saved = {name: getattr(dist, name) for name in wrappers}
    return wrappers, saved


def _functional_mode(log: WireLog):
    """A dispatch mode logging the functional collectives (DTensor's)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = {"all_reduce": "all_reduce",
           "all_gather_into_tensor": "all_gather",
           "reduce_scatter_tensor": "reduce_scatter",
           "all_to_all_single": "all_to_all",
           "broadcast": "broadcast"}

    from torch.distributed.tensor import DTensor

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                # let DTensor run the op: the collectives it issues on its
                # local tensors come back through this mode
                return NotImplemented
            packet = func.overloadpacket
            if getattr(packet, "_qualified_op_name", "").startswith(
                    "_c10d_functional::"):
                name = packet.__name__
                if name in ops:
                    group = _resolve_process_group(args[-1])
                    log.add(_entry(ops[name], args[0],
                                   dist.get_world_size(group)), group)
            return func(*args, **(kwargs or {}))

    return Mode()


@contextlib.contextmanager
def record_wire(communicate: bool = True):
    """Record this rank's collectives while the context is open (module
    docstring); yields the ``WireLog``.  ``communicate=False``: record the
    torch.distributed calls without sending anything."""
    log = WireLog()
    wrappers, saved = _c10d_wrappers(log, communicate)
    for name, fn in wrappers.items():
        setattr(dist, name, fn)
    try:
        with _functional_mode(log):
            yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
