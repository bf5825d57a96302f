"""Differentiable collectives over one mesh dimension (the "model" group)
for tensor and sequence parallelism, each a ``torch.autograd.Function``
whose backward is its forward's transpose (Megatron-LM's mappings; the
collectives GSPMD inserts for the reference's sharded program):

  enter         identity forward, all-reduce backward: a tensor replicated
                over the group entering per-rank work (column-parallel
                products);
  sum_shards    all-reduce forward, identity backward: per-rank partial
                sums leaving it (row-parallel products);
  gather_seq    all-gather of dim ``dim`` forward, reduce-scatter backward:
                the sequence made whole for work whose gradients are
                partial sums over the group;
  scatter_seq   own slice of dim ``dim`` forward, all-gather backward: a
                replicated tensor whose gradient is the same on every rank
                split into the rank's slice;
  reduce_scatter_seq  reduce-scatter of dim ``dim`` forward, all-gather
                backward: row-parallel partial sums leaving as the rank's
                sequence slice;
  gather_shards all-gather of dim ``dim`` forward, own slice backward:
                slices made whole for work that is the same on every rank
                (its gradient too).

The gathers and their transposes take ``sizes``, each rank's length of
``dim``, for uneven parts (a rank's whole heads where the heads do not
divide the group): padded to the longest on the wire.

A group of one rank is the identity in every direction.  Only all-reduce,
all-gather, reduce-scatter and all-to-all are used: gloo refuses
point-to-point on CUDA tensors.  Every collective goes through
``torch.distributed``'s module functions, so ``util.wire.record_wire``
logs them.  The plain functions at the end (``all_gather``, ``all_max``)
are for work without a gradient (decode, a no-grad statistic).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _n(group) -> int:
    return dist.get_world_size(group)


def all_gather(x: torch.Tensor, group, dim: int = 0,
               sizes=None) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order.
    ``sizes`` (each rank's length of ``dim``; None: all equal) gathers
    uneven parts, a rank's whole heads of heads that do not divide:
    ``all_gather_into_tensor`` takes equal shards on gloo and NCCL alike,
    so each part is padded to the longest, gathered, and the padding
    dropped (a rank of length 0 sends padding only)."""
    n = _n(group)
    if n == 1:
        return x
    top = x.shape[dim] if sizes is None else max(sizes)
    moved = x.movedim(dim, 0)
    if moved.shape[0] < top:
        moved = torch.cat([moved, moved.new_zeros(
            (top - moved.shape[0],) + tuple(moved.shape[1:]))])
    moved = moved.contiguous()
    out = torch.empty((n * top,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, moved, group=group)
    if sizes is not None and min(sizes) < top:
        out = torch.cat([out[r * top:r * top + s]
                         for r, s in enumerate(sizes)])
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0,
                   sizes=None) -> torch.Tensor:
    """The group's tensors summed, this rank's slice of ``dim`` kept
    (``sizes``: each rank's length of the slice, as ``all_gather`` takes
    them; the parts padded to the longest, the padding dropped)."""
    n = _n(group)
    if n == 1:
        return x
    moved = x.movedim(dim, 0)
    top = moved.shape[0] // n if sizes is None else max(sizes)
    if sizes is not None and min(sizes) < top:
        parts, start = [], 0
        for s in sizes:
            part = moved[start:start + s]
            start += s
            parts += [part, part.new_zeros((top - s,)
                                           + tuple(moved.shape[1:]))]
        moved = torch.cat(parts)
    moved = moved.contiguous()
    out = torch.empty((top,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, op=dist.ReduceOp.SUM, group=group)
    if sizes is not None:
        out = out[:sizes[dist.get_rank(group)]]
    return out.movedim(0, dim)


def own_slice(x: torch.Tensor, group, dim: int,
              sizes=None) -> torch.Tensor:
    """This rank's slice of ``dim`` (a view): an equal one, or of
    ``sizes`` (each rank's length, in rank order)."""
    rank = dist.get_rank(group)
    if sizes is None:
        size = x.shape[dim] // _n(group)
        return x.narrow(dim, rank * size, size)
    return x.narrow(dim, sum(sizes[:rank]), sizes[rank])


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x`` summed over the group."""
    out = x.contiguous().clone()
    if _n(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``x``, its elementwise maximum over the group."""
    out = x.contiguous().clone()
    if _n(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return all_gather(x, group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.group, ctx.dim, ctx.sizes), None,
                None, None)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        return all_gather(x, group, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return own_slice(g, ctx.group, ctx.dim, ctx.sizes), None, None, None


def enter(x, group):
    return x if _n(group) == 1 else _Enter.apply(x, group)


def sum_shards(x, group):
    return x if _n(group) == 1 else _SumShards.apply(x, group)


def gather_seq(x, group, dim: int = 1, sizes=None):
    return x if _n(group) == 1 else _GatherSeq.apply(x, group, dim, sizes)


def scatter_seq(x, group, dim: int = 1):
    return x if _n(group) == 1 else _ScatterSeq.apply(x, group, dim)


def reduce_scatter_seq(x, group, dim: int = 1):
    return x if _n(group) == 1 else _ReduceScatterSeq.apply(x, group, dim)


def gather_shards(x, group, dim: int = 0, sizes=None):
    return x if _n(group) == 1 else _GatherShards.apply(x, group, dim, sizes)
