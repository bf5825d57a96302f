"""Optimizers: AdamW and Adafactor (factored second moments for ≥34B
configs, where fp32 Adam state would not fit), plus global-norm clipping
and a warmup-cosine schedule.  Counterpart of
``repro/optim/optimizers.py``.

Pure functions on trees of tensors (nested dicts and lists; None holds no
leaf) in the reference's layout: each stack's ``groups/p{i}`` leaves are
stacked over the layer groups, with the group index first
(``train.steps`` keeps the parameters that way).  Every rule that reads a
leaf's shape reads the stacked shape, as the reference's does:

* decoupled weight decay applies where ``p.ndim >= 2``, so it decays the
  stacked norm scales and biases (G, D) too;
* Adafactor factors every leaf whose last two dims exceed 1
  (``_factored``): a stacked norm scale (G, D) gets ``vr`` (G,) and a
  ``vc`` (D,) shared across the group's layers;
* Adafactor's RMS clip of the update averages over the whole leaf.

State keeps the reference's dict layout (``{"m", "v", "count"}``,
``{"v": {… "vr", "vc" | "v"}, "count"}``, ``{"count"}``), so a train
checkpoint restores in either package.  Moments are fp32; the schedule is
computed in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"              # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.1
    adafactor_eps: float = 1e-30


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure): dicts, lists and tuples are
    containers, None holds no leaf.  Dicts are visited in sorted key order,
    as JAX flattens them, so sums over leaves (the global norm) add in
    the reference's order whatever order a dict was built in."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then cosine down to
    ``min_lr_ratio``·lr at ``total_steps``; fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves))


def clip_by_global_norm(grads, max_norm, *, norm=None):
    """(grads scaled so their global norm is at most ``max_norm``, the norm
    before clipping).  ``norm`` replaces the norm of ``grads`` (the sharded
    step passes the norm over every rank's shard)."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _decay(step, p, cfg):
    """Decoupled weight decay on every leaf of two or more dims."""
    if p.ndim >= 2:
        return step + cfg.weight_decay * p.float()
    return step


# -------------------------------------------------------------------- AdamW

def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def adamw_update(cfg: OptConfig, grads, state, params):
    c = state["count"] + 1
    cf = c.to(torch.float32)
    lr = schedule(cfg, c)
    bc1 = 1 - _f32(cfg.b1, cf) ** cf
    bc2 = 1 - _f32(cfg.b2, cf) ** cf

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step = _decay(step, p, cfg)
        return (p.float() - lr * step).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return (_part(params, out, 0),
            {"m": _part(params, out, 1), "v": _part(params, out, 2),
             "count": c})


def _part(params, out, i: int):
    """Item ``i`` of the tuples at ``params``' leaf positions of ``out``."""
    return tree_map(lambda _p, t: t[i], params, out)


# ---------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params):
    def leaf(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    first = tree_leaves(params)[0]
    return {"v": tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def _adafactor_leaf(cfg, g, v, p, beta2, lr):
    """One leaf's Adafactor step: (new param, new state dict).  Leaf-sized
    temporaries are dropped as soon as they are spent (an expert leaf of
    dbrx-132b is 1.06 B elements, 4.2 GB in fp32)."""
    g32 = g.float()
    g2 = g32 * g32 + cfg.adafactor_eps
    if _factored(p.shape):
        vr = beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
        vc = beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
        del g2
        denom = (vr / torch.mean(vr, dim=-1, keepdim=True))[..., None] \
            * vc[..., None, :]
        step = g32 * denom.add_(cfg.adafactor_eps).rsqrt_()
        del denom
        nv = {"vr": vr, "vc": vc}
    else:
        nv = {"v": beta2 * v["v"] + (1 - beta2) * g2}
        del g2
        step = g32 * torch.rsqrt(nv["v"] + cfg.adafactor_eps)
    del g32
    # update clipping (RMS <= 1) per Adafactor, over the whole leaf
    rms = torch.sqrt(torch.mean(step * step) + 1e-30)
    step.div_(torch.clamp(rms, min=1.0))
    step = _decay(step, p, cfg)
    return (p.float() - lr * step).to(p.dtype), nv


def adafactor_update(cfg: OptConfig, grads, state, params):
    c = state["count"] + 1
    cf = c.to(torch.float32)
    lr = schedule(cfg, c)
    beta2 = 1.0 - cf ** -0.8                       # Shazeer-Stern schedule
    # traversed along params: a state leaf is its dict ("vr", "vc" | "v")
    out = tree_map(lambda p, g, v: _adafactor_leaf(cfg, g, v, p, beta2, lr),
                   params, grads, state["v"])
    return _part(params, out, 0), {"v": _part(params, out, 1), "count": c}


# ------------------------------------------------------------------ facade

def init_opt_state(kind: str, params):
    if kind == "adamw":
        return adamw_init(params)
    if kind == "adafactor":
        return adafactor_init(params)
    if kind == "sgd":
        first = tree_leaves(params)[0]
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}
    raise ValueError(kind)


def apply_updates(cfg: OptConfig, grads, state, params, *, norm=None):
    """(new params, new state, global grad norm before clipping).
    ``norm`` replaces the global norm of ``grads`` (see
    ``clip_by_global_norm``)."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm, norm=norm)
    if cfg.kind == "adamw":
        new_p, new_s = adamw_update(cfg, grads, state, params)
    elif cfg.kind == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params)
    elif cfg.kind == "sgd":
        c = state["count"] + 1
        lr = schedule(cfg, c)
        new_p = tree_map(lambda p, g: (p.float() - lr * g.float())
                         .to(p.dtype), params, grads)
        new_s = {"count": c}
    else:
        raise ValueError(cfg.kind)
    return new_p, new_s, gn
