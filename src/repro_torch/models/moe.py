"""Mixture-of-Experts FFN with capacity-based dispatch.  Counterpart of
``repro/models/moe.py``'s ``local`` path: tokens routed to (E, C) slots via
a sort-based rank computation, experts applied as one batched product.
Flops are honest: E·C·d·ff with E·C = tokens·top_k·capacity_factor.

Router: softmax top-k (``lax.top_k``'s tie order), Switch-style
load-balance auxiliary loss + z-loss.  Overflowed tokens (beyond capacity)
are dropped (their combine weight is 0), standard for capacity-based MoE
at scale.

The reference's expert-parallel path (``moe_ep``, under ``shard_map``) is
reached only through a ``Runtime`` with a mesh, which only training builds;
it goes with the training slice (ROADMAP.md item 12b).
"""

from __future__ import annotations

import functools

import torch

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
    f = torch.bincount(expert_idx.reshape(-1), minlength=E).float()
    f = f / max(expert_idx.numel(), 1)
    pbar = probs.mean(0)
    aux = E * torch.sum(f * pbar) * cfg.moe.router_aux_weight
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) \
        * cfg.moe.router_z_weight
    return expert_idx, weights, aux, z


def _positions_in_expert(expert_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each assignment within its expert, computed via one stable
    argsort (no N×E one-hot materialisation)."""
    N = expert_flat.shape[0]
    order = torch.argsort(expert_flat, stable=True)
    counts = torch.bincount(expert_flat, minlength=E)
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


def moe_ep(*args, **kwargs):
    """Expert parallelism over a mesh: goes with training (item 12b)."""
    del args, kwargs
    raise NotImplementedError(
        "moe_ep (expert parallelism over a device mesh) goes with the "
        "training slice, ROADMAP.md queue 1 item 12b; the port's MoE runs "
        "moe_local on one device")
