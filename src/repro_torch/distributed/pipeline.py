"""GPipe-style pipeline parallelism over a mesh axis.  Counterpart of
``repro/distributed/pipeline.py``.

Stage s holds its slice of layer parameters (leading dim = n_stages,
sharded over the "pp" axis: a DTensor ``Shard(0)`` or its local tensor).
Forward runs the classic GPipe schedule: at tick t, stage s processes
microbatch (t − s); there are M + S − 1 ticks, so the bubble is
(S − 1)/(M + S − 1).  Activations hop stage to stage (s → s + 1, the last
back to the first, as the reference's cyclic ``ppermute``), and the last
stage's outputs are summed over the axis so every stage returns them.

Everything is differentiable, so ``backward`` through ``pipeline_apply``
gives the sequential stack's gradients with GPipe scheduling:

  * the hop is an autograd function over one ``all_to_all_single`` on the
    axis's process group, whose only non-empty split goes to the next
    stage; its backward is the reverse permute.  One collective serves
    NCCL and gloo, CPU and CUDA tensors alike: gloo's point-to-point
    cannot take CUDA tensors (it aborts with "writev: Bad address" on
    ranks sharing one card), its all-to-all can;
  * the final sum is ``models.moe._SumShards`` (an all-reduce whose
    gradient is each rank's own).

Every stage runs ``stage_fn`` at every tick, feeds the activation it
received into its input (the first stage selects its microbatch instead)
and writes its output into the result where valid, each through
``torch.where``, as the reference's scan does: every rank builds the same
graph, its loss depends on every hop, and the backward permutes pair up
in the same order on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.moe import _SumShards


def _exchange(x: torch.Tensor, group, send_to: int, recv_from: int):
    """Send ``x`` to group rank ``send_to`` and receive a tensor of its
    shape from group rank ``recv_from``, over ``group``: an all-to-all
    with one non-empty split each way."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n, size = x.numel(), dist.get_world_size(group)
    dist.all_to_all_single(
        out.view(-1), x.view(-1),
        output_split_sizes=[n if j == recv_from else 0 for j in range(size)],
        input_split_sizes=[n if j == send_to else 0 for j in range(size)],
        group=group)
    return out


class _Hop(torch.autograd.Function):
    """Each stage's activation to the next stage (the last's to the
    first); backward, each gradient back to the stage it came from."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.prv, ctx.nxt), None, None, None


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, axis: str = "pp") -> torch.Tensor:
    """Run microbatches through the pipeline.

    stage_fn: (params_for_one_stage, x (mb, ...)) -> y (mb, ...)
    stage_params: tree of this rank's slice of the leading n_stages dim
        (leading dim 1): DTensors sharded ``Shard(0)`` over ``axis`` or
        their local tensors
    x_micro: (n_micro, mb, ...) microbatched input, the same on every stage
    mesh: a ``DeviceMesh`` with an ``axis`` dim (the stages)

    Returns y_micro (n_micro, mb, ...), the same on every stage (the last
    stage's outputs, summed over the axis).
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    me = dist.get_rank(group)
    params_me = _tree_map(lambda p: _local(p)[0], stage_params)
    n_micro = x_micro.shape[0]
    if n_stages == 1:
        return torch.stack([stage_fn(params_me, x_micro[i])
                            for i in range(n_micro)])
    nxt, prv = (me + 1) % n_stages, (me - 1) % n_stages
    first = torch.tensor(me == 0, device=x_micro.device)
    buf = torch.zeros_like(x_micro[0])
    outs = [torch.zeros_like(x_micro[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        mb_idx = min(max(t - me, 0), n_micro - 1)
        y = stage_fn(params_me, torch.where(first, x_micro[mb_idx], buf))
        # the last stage keeps its (valid) result for microbatch t − (S−1);
        # every stage's outputs stay in the graph, so every rank's loss
        # runs the backward permutes
        out_idx = min(max(t - (n_stages - 1), 0), n_micro - 1)
        valid = me == n_stages - 1 and 0 <= t - (n_stages - 1) < n_micro
        outs[out_idx] = torch.where(torch.tensor(valid, device=y.device), y,
                                    outs[out_idx])
        if t < n_micro + n_stages - 2:        # the last hop feeds nothing
            buf = _Hop.apply(y, group, nxt, prv)
    mask = 1.0 if me == n_stages - 1 else 0.0
    return _SumShards.apply(torch.stack(outs) * mask, group)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe's idle share: (S − 1)/(M + S − 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def make_pipelined_loss(stage_fn, loss_fn, mesh, axis: str = "pp"):
    """loss over microbatches: mean of loss_fn(y_micro[i], t_micro[i])."""
    def pipe_loss(stage_params, x_micro, t_micro):
        y = pipeline_apply(stage_fn, stage_params, x_micro, mesh, axis)
        return torch.stack([loss_fn(y[i], t_micro[i])
                            for i in range(y.shape[0])]).mean()
    return pipe_loss
