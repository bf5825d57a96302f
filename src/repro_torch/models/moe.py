"""Mixture-of-Experts FFN with capacity-based dispatch and expert
parallelism.  Counterpart of ``repro/models/moe.py``.

Two execution paths share one dispatch algorithm:

* ``moe_local``: one device — tokens routed to (E, C) slots via a
  sort-based rank computation, experts applied as one batched product.
  Flops are honest: E·C·d·ff with E·C = tokens·top_k·capacity_factor.
* ``moe_ep``: expert parallelism over the "model" dim of a
  ``DeviceMesh``, the reference's ``shard_map`` body on each rank.  The
  rank holds its own shard of the batch (split over the data dims),
  replicated over "model"; when the tokens divide it (1) takes its
  sequence shard over "model", (2) routes locally with per-shard
  capacity, (3) all-to-alls the slots to their experts' ranks, (4) runs
  its E/mp experts, (5) all-to-alls back and combines, (6) all-gathers
  the token shards.  Otherwise (decode-sized inputs) each rank runs its
  own experts on every token and the outputs are summed over "model".

The collectives are differentiable (``distributed.tensor_parallel``),
each with the transpose the reference's ``shard_map`` gives it: a
replicated input enters the expert region through ``_Enter`` (identity;
its gradient is summed over "model"), the output leaves through
``_GatherShards`` / ``_SumShards`` (all-gather / all-reduce; the gradient
of a replicated output is each rank's own slice / itself), and
``_AllToAll`` sends gradients back the way the slots came.  So every
rank's gradients are the same across "model", and the data-parallel step
averages them over the data dims; expert weights passed as the rank's own
E/mp rows keep a gradient of those rows alone (no all-reduce over
"model").  A model on a runtime over "model" passes ``moe_ep`` the routed
experts only and runs the shared expert through the common
tensor-parallel FFN beside it (``transformer._apply_ffn``).

Router: softmax top-k (``lax.top_k``'s tie order), Switch-style
load-balance auxiliary loss + z-loss.  Overflowed tokens (beyond capacity)
are dropped (their combine weight is 0), standard for capacity-based MoE
at scale.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.distributed.tensor_parallel import (_Enter, _GatherShards,
                                                      _SumShards)
from repro_torch.models.common import KeyGen, dense_init, normal, silu
from repro_torch.util.order import top_k


def init_moe(seed, cfg, *, device):
    kg = KeyGen(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    pdt = cfg.param_dtype_torch

    def einit(s, *shape):
        return (normal(s, shape, device=device) * shape[1] ** -0.5).to(pdt)

    p = {
        "router": dense_init(kg(), D, E, torch.float32, scale=D ** -0.5,
                             device=device),
        "wi_gate": einit(kg(), E, D, F),
        "wi_up": einit(kg(), E, D, F),
        "wo": einit(kg(), E, F, D),
    }
    if cfg.moe.shared_expert:
        p["shared"] = {
            "wi_gate": dense_init(kg(), D, F, pdt, device=device),
            "wi_up": dense_init(kg(), D, F, pdt, device=device),
            "wo": dense_init(kg(), F, D, pdt, device=device),
        }
    return p


def _expert_ffn(wi_gate, wi_up, wo, x):
    """Batched SwiGLU expert FFN: x (E, C, D) -> (E, C, D)."""
    g = torch.bmm(x, wi_gate.to(x.dtype))
    u = torch.bmm(x, wi_up.to(x.dtype))
    h = silu(g) * u
    return torch.bmm(h, wo.to(x.dtype))


def _route(router_w, x_flat, cfg):
    """Returns (expert_idx (N,K), weights (N,K), aux_loss, z_loss)."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    logits = (x_flat.float() @ router_w.float()).float()
    probs = torch.softmax(logits, dim=-1)
    weights, expert_idx = top_k(probs, K)
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    # Switch load-balance loss: E * sum_e f_e * p_e
    f = _expert_counts(expert_idx.reshape(-1), E).float()
    f = f / max(expert_idx.numel(), 1)
    pbar = probs.mean(0)
    aux = E * torch.sum(f * pbar) * cfg.moe.router_aux_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) \
        * cfg.moe.router_z_weight
    return expert_idx, weights, aux, z


def _expert_counts(expert_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Assignments per expert, (E,) int64: ``bincount(minlength=E)`` for
    indices below E, with a shape that does not depend on the data (so
    the dry run's fake tensors run it)."""
    counts = torch.zeros(E, dtype=torch.int64, device=expert_flat.device)
    return counts.scatter_add_(0, expert_flat.long(),
                               torch.ones_like(expert_flat, dtype=torch.int64))


def _positions_in_expert(expert_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each assignment within its expert, computed via one stable
    argsort (no N×E one-hot materialisation)."""
    N = expert_flat.shape[0]
    order = torch.argsort(expert_flat, stable=True)
    counts = _expert_counts(expert_flat, E)
    offsets = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(N, device=expert_flat.device) \
        - offsets[expert_flat[order]]
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    return pos


def _dispatch_combine(p, x_flat, cfg, capacity: int, expert_fn):
    """Shared dispatch → expert_fn((E, C, D)) → combine. Returns (out, aux)."""
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    N, D = x_flat.shape
    expert_idx, weights, aux, z = _route(p["router"], x_flat, cfg)

    flat_e = expert_idx.reshape(-1)                       # (N*K,)
    pos = _positions_in_expert(flat_e, E)
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, E * capacity)

    tok_of = torch.arange(N, device=x_flat.device).repeat_interleave(K)
    # index_add_ is exact here: a kept slot receives one token; the drop
    # slot E·capacity takes every dropped one and is cut off
    slots = torch.zeros((E * capacity + 1, D), dtype=x_flat.dtype,
                        device=x_flat.device)
    slots.index_add_(0, slot, x_flat[tok_of])
    slots = slots[:-1].reshape(E, capacity, D)

    out_slots = expert_fn(slots).reshape(E * capacity, D)
    out_slots = torch.cat(
        [out_slots, torch.zeros((1, D), dtype=out_slots.dtype,
                                device=out_slots.device)], 0)

    gathered = out_slots[slot].reshape(N, K, D)
    w = (weights * keep.reshape(N, K)).float()
    out = torch.einsum("nkd,nk->nd", gathered.float(), w)
    return out.to(x_flat.dtype), aux + z


def moe_local(p, x, cfg, *, dropless: bool = False):
    """Single-device MoE.  x (B, S, D) -> (y, aux_loss).

    dropless=True sets capacity to the worst case (T·K) — used for decode,
    where token counts are tiny and drops would corrupt generation."""
    B, S, D = x.shape
    x_flat = x.reshape(B * S, D)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    if dropless:
        capacity = B * S * K
    else:
        capacity = max(int(B * S * K * cfg.moe.capacity_factor / E), 1)
    fn = functools.partial(_expert_ffn, p["wi_gate"], p["wi_up"], p["wo"])
    out, aux = _dispatch_combine(p, x_flat, cfg, capacity, fn)
    out = out.reshape(B, S, D)
    if cfg.moe.shared_expert:
        out = out + _shared_ffn(p["shared"], x)
    return out, aux


def _shared_ffn(p, x):
    g = x @ p["wi_gate"].to(x.dtype)
    u = x @ p["wi_up"].to(x.dtype)
    return (silu(g) * u) @ p["wo"].to(x.dtype)


# --------------------------------------------------------------------- EP --

class _AllToAll(torch.autograd.Function):
    """Equal chunks of dim 0 exchanged over ``group``: chunk j goes to rank
    j, and chunk j of the result came from rank j.  The gradient goes back
    the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _MeanAux(torch.autograd.Function):
    """The router loss averaged over the data and model groups (the
    reference's ``pmean``).  Every rank's loss carries the average; the
    data-parallel step averages gradients over the data dims, so a rank
    passes ``1/mp`` of its cotangent to its own term and the expert
    region's entry sums those over "model"."""

    @staticmethod
    def forward(ctx, aux, groups, mp):
        ctx.mp = mp
        out = aux.detach().clone()
        n = 1
        for g in groups:
            dist.all_reduce(out, group=g)
            n *= dist.get_world_size(g)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.mp, None, None


def moe_ep(p, x, cfg, mesh, *, data_axes=("pod", "data"), model_axis="model"):
    """Expert-parallel MoE (see the module docstring).  ``mesh`` is a
    ``DeviceMesh`` with a ``model_axis`` dim; ``x`` (B, S, D) is this
    rank's shard of the batch, the same on every rank of its "model"
    group.  Each rank runs experts ``my·E/mp … (my+1)·E/mp``.  The expert
    tensors are either whole (E rows, the same on every rank: the rank
    takes its rows, and their gradient is summed over "model") or this
    rank's own E/mp rows (as the train step passes them: their gradient
    stays the rank's own).  Returns (y (B, S, D) replicated over "model",
    aux)."""
    group = mesh.get_group(model_axis)
    mp = dist.get_world_size(group)
    my = dist.get_rank(group)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    if E % mp:
        raise ValueError(f"{E} experts do not divide over {mp} ranks")
    names = tuple(mesh.mesh_dim_names)
    dgroups = [mesh.get_group(a) for a in data_axes if a in names]
    e_loc = E // mp
    B, S, D = x.shape
    T = B * S
    x_flat = _Enter.apply(x, group).reshape(T, D)
    rw = _Enter.apply(p["router"], group)
    lo = my * e_loc
    rows = p["wi_gate"].shape[0]
    if rows == E:
        wg = _Enter.apply(p["wi_gate"], group)[lo:lo + e_loc]
        wu = _Enter.apply(p["wi_up"], group)[lo:lo + e_loc]
        wo = _Enter.apply(p["wo"], group)[lo:lo + e_loc]
    elif rows == e_loc:
        wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    else:
        raise ValueError(f"expert tensors of {rows} rows: neither all {E} "
                         f"experts nor this rank's {e_loc}")

    if T % mp == 0 and T >= mp:
        # sequence-shard the tokens over the model group
        t = T // mp
        xs = x_flat[my * t:(my + 1) * t]
        capacity = max(int(t * K * cfg.moe.capacity_factor / E), 1)

        def expert_fn(slots):                     # (E, C, D) on every rank
            recv = _AllToAll.apply(slots.reshape(mp, e_loc, capacity, D),
                                   group)
            # recv (mp, E_loc, C, D): slots for my experts, peer-major
            mine = recv.transpose(0, 1).reshape(e_loc, mp * capacity, D)
            out = _expert_ffn(wg, wu, wo, mine)
            out = out.reshape(e_loc, mp, capacity, D).transpose(0, 1)
            back = _AllToAll.apply(out.contiguous(), group)
            return back.reshape(E, capacity, D)

        out, aux = _dispatch_combine({"router": rw}, xs, cfg, capacity,
                                     expert_fn)
        out = _GatherShards.apply(out, group, 0, None)
    else:
        # tiny token counts (decode): every rank runs its own experts on
        # every token; the outputs are summed over the model group
        expert_idx, weights, aux, z = _route(rw, x_flat, cfg)
        aux = aux + z
        local = expert_idx - lo
        onehot = (local[..., None] == torch.arange(
            e_loc, device=x.device)).float()      # 0 outside my experts
        w_loc = torch.einsum("tk,tke->te", weights, onehot)   # (T, E_loc)
        h = torch.einsum("td,edf->tef", x_flat, wg.to(x_flat.dtype))
        u = torch.einsum("td,edf->tef", x_flat, wu.to(x_flat.dtype))
        o = torch.einsum("tef,efd->ted", silu(h) * u, wo.to(x_flat.dtype))
        out = torch.einsum("ted,te->td", o.float(), w_loc)
        out = _SumShards.apply(out.to(x_flat.dtype), group)

    out = out.reshape(B, S, D)
    shared = p.get("shared")
    if shared is not None:
        # the shared expert tensor-parallel over "model": F split, summed
        F = shared["wi_gate"].shape[1]
        if F % mp:
            raise ValueError(f"the shared expert's {F} columns do not "
                             f"divide over {mp} ranks")
        f0, fl = my * (F // mp), F // mp
        sg = _Enter.apply(shared["wi_gate"], group)[:, f0:f0 + fl]
        su = _Enter.apply(shared["wi_up"], group)[:, f0:f0 + fl]
        so = _Enter.apply(shared["wo"], group)[f0:f0 + fl]
        x_in = x_flat.reshape(B, S, D)
        y = (silu(x_in @ sg.to(x.dtype)) * (x_in @ su.to(x.dtype))) \
            @ so.to(x.dtype)
        out = out + _SumShards.apply(y, group)
    aux = _MeanAux.apply(aux, dgroups + [group], mp)
    return out, aux
