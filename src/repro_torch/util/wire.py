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

Bytes received count an optimal collective on g ranks (paper §2.3, as
``core.costmodel.Machine.collective_words``): an all-gather (g−1)/g of its
output, a reduce-scatter and an all-to-all (g−1)/g of their input, an
all-reduce 2(g−1)/g of its tensor, a broadcast its tensor once.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

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
    """The collectives recorded, in issue order."""

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


def _c10d_wrappers(log: WireLog) -> dict:
    def all_reduce(tensor, *args, group=None, **kw):
        log.append(_entry("all_reduce", tensor, _group_size(group)))
        return saved["all_reduce"](tensor, *args, group=group, **kw)

    def all_gather_into_tensor(out, inp, *args, group=None, **kw):
        log.append(_entry("all_gather", inp, _group_size(group)))
        return saved["all_gather_into_tensor"](out, inp, *args, group=group,
                                               **kw)

    def all_gather(out_list, tensor, *args, group=None, **kw):
        log.append(_entry("all_gather", tensor, _group_size(group)))
        return saved["all_gather"](out_list, tensor, *args, group=group, **kw)

    def all_to_all_single(out, inp, *args, group=None, **kw):
        log.append(_entry("all_to_all", inp, _group_size(group)))
        return saved["all_to_all_single"](out, inp, *args, group=group, **kw)

    def reduce_scatter_tensor(out, inp, *args, group=None, **kw):
        log.append(_entry("reduce_scatter", inp, _group_size(group)))
        return saved["reduce_scatter_tensor"](out, inp, *args, group=group,
                                              **kw)

    def broadcast(tensor, *args, group=None, **kw):
        log.append(_entry("broadcast", tensor, _group_size(group)))
        return saved["broadcast"](tensor, *args, group=group, **kw)

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
                    log.append(_entry(ops[name], args[0],
                                      dist.get_world_size(group)))
            return func(*args, **(kwargs or {}))

    return Mode()


@contextlib.contextmanager
def record_wire():
    """Record this rank's collectives while the context is open (module
    docstring); yields the ``WireLog``."""
    log = WireLog()
    wrappers, saved = _c10d_wrappers(log)
    for name, fn in wrappers.items():
        setattr(dist, name, fn)
    try:
        with _functional_mode(log):
            yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
