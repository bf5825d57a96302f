"""Shared model building blocks: norms, positions, initializers, dtypes, and
the parameter container the model's modules are built on.  Counterpart of
``repro/models/common.py``.

``KeyGen`` hands out integer seeds, each derived from its parent seed and
a counter (splitmix64), and every initializer draws from its own
``torch.Generator`` seeded with one of them, on the device the parameter
lives on: the order in which modules are built cannot skew another
module's draws.  The port does not reproduce ``jax.random``'s streams;
parity tests carry the JAX parameters across (``util/convert.py``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

Params = dict[str, Any]

_MASK64 = (1 << 64) - 1


# ----------------------------------------------------------------- init utils

def fold_in(seed: int, i: int) -> int:
    """A seed derived from (seed, i) by splitmix64; distinct counters give
    unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1          # a non-negative int64 seed


class KeyGen:
    """Deterministic seed dispenser so init order can't skew seeds."""

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._i = 0

    def __call__(self) -> int:
        self._i += 1
        return fold_in(self._seed, self._i)


def normal(seed: int, shape, *, device) -> torch.Tensor:
    """Standard normal fp32 draws of ``shape`` on ``device`` from ``seed``
    (on the ``meta`` device: shape only)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device)


def uniform(seed: int, shape, lo: float, hi: float, *, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.empty(tuple(shape), dtype=torch.float32,
                       device=device).uniform_(lo, hi, generator=gen)


def dense_init(seed, in_dim, out_dim, dtype, scale: float | None = None, *,
               device):
    scale = scale if scale is not None else in_dim ** -0.5
    return (normal(seed, (in_dim, out_dim), device=device) * scale).to(dtype)


def embed_init(seed, vocab, dim, dtype, *, device):
    return (normal(seed, (vocab, dim), device=device) * 0.02).to(dtype)


# ----------------------------------------------------------- the containers

class ParamTree(nn.Module):
    """An ``nn.Module`` built from the reference's nested parameter dict:
    a dict becomes a submodule, a list an ``nn.ModuleList``, a tensor an
    ``nn.Parameter`` of the dict key's name, so ``state_dict`` keys are the
    reference's key paths joined by dots.  ``p["wq"]``, ``p.get("bq")`` and
    ``"bo" in p`` read it as the reference's functions read their dict, so
    the functional code takes either."""

    def __init__(self, tree: Params):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(name, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(name, nn.Parameter(
                    v, requires_grad=v.is_floating_point()))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return getattr(self, name) if name in self else default

    def tree(self) -> Params:
        """The nested dict of tensors this module was built from."""
        out: Params = {n: p.data for n, p in self._parameters.items()}
        for n, m in self._modules.items():
            out[n] = ([c.tree() for c in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


# ----------------------------------------------------------------------- norms

def rms_norm(x, weight, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def init_norm(seed, dim, dtype, kind: str, *, device):
    del seed
    if kind == "rms":                                  # stored as (1+s)
        return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def apply_norm(p, x, kind: str):
    if kind == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ------------------------------------------------------------------ positions

def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over the last dim of x (..., T, n_heads, head_dim)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # (..., T, half)
    ang = ang[..., None, :]                                    # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_freqs(dim: int, device) -> torch.Tensor:
    half = dim // 2
    return torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32, *,
                         device="cpu"):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    ang = pos * sinusoidal_freqs(dim, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -------------------------------------------------------------------- helpers

def gelu(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def silu(x):
    x32 = x.float()
    return (x32 * torch.sigmoid(x32)).to(x.dtype)
