"""numpy <-> torch conversion, and carrying factors and sparse storage
between the packages.

The JAX package and the port meet only through numpy arrays: a JAX
``NMFResult``'s ``W``/``H`` (``np.asarray(res.W)``) come in through
``factors_from_numpy`` and a port result goes out through
``result_to_numpy``; a JAX ``BlockCOO``'s leaves come in through
``blockcoo_from_numpy`` and go back through ``blockcoo_to_numpy``.  numpy
has no bfloat16, so bf16 tensors leave as float32 (exact: every bf16 value
is an fp32 value).
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(x, *, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array (bfloat16 ones included),
    a tensor or a scalar."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16, which torch lacks
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    if not arr.flags.writeable:        # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    return torch.as_tensor(arr, device=device, dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def factors_from_numpy(W, H, *, device, dtype: torch.dtype = torch.float32
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W (m, k), H (k, n)) as contiguous tensors on ``device`` — what
    ``NMFSolver.fit(W0=, H0=)`` and ``fit(init=)`` take."""
    return (to_torch(W, device=device, dtype=dtype).contiguous(),
            to_torch(H, device=device, dtype=dtype).contiguous())


def result_to_numpy(res) -> tuple[np.ndarray, np.ndarray]:
    """(W, H) of a port ``NMFResult`` as numpy arrays — usable as the JAX
    package's ``fit(init=(W, H))`` or ``fit(W0=W, H0=H)``."""
    return to_numpy(res.W), to_numpy(res.H)


def blockcoo_from_numpy(blk, *, device="cpu"):
    """The port's ``BlockCOO`` from a JAX package ``BlockCOO`` (or any
    object with its fields): each leaf through ``np.asarray``, the sort
    metadata and ``align`` included, so a layout sorted by one package runs
    in the other."""
    from repro_torch.core.blocksparse import LEAVES, BlockCOO
    leaves = {f: None if getattr(blk, f) is None
              else to_torch(getattr(blk, f), device=device) for f in LEAVES}
    return BlockCOO(shape=tuple(blk.shape), block_shape=tuple(blk.block_shape),
                    nnz=int(blk.nnz), align=int(blk.align), **leaves)


def blockcoo_to_numpy(blk) -> dict:
    """The fields of a port ``BlockCOO`` as numpy arrays (None where a
    sort leaf is absent) plus its shapes, nnz and align: the keyword
    arguments of the JAX package's ``BlockCOO`` once each array is wrapped
    in ``jnp.asarray`` (bf16 values come out as float32)."""
    from repro_torch.core.blocksparse import LEAVES
    out = {f: None if getattr(blk, f) is None else to_numpy(getattr(blk, f))
           for f in LEAVES}
    out.update(shape=tuple(blk.shape), block_shape=tuple(blk.block_shape),
               nnz=int(blk.nnz), align=int(blk.align))
    return out


# ------------------------------------------------------------ model params

_STACKS = ("enc", "dec")


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _leading_dim(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def lm_params_from_numpy(cfg, tree, *, device=None):
    """A port ``models.lm.LM`` holding the JAX package's parameters:
    ``tree`` is the reference's nested dict (``jax.tree.map(np.asarray,
    params)``; a leaf may also be a tensor, e.g. a bf16 one where numpy
    has no bf16), stacked ``{enc,dec}/groups/p{i}`` leaves and ``tail``
    list included; group g of ``p{i}`` becomes layer g·period + i."""
    from repro_torch.models.lm import LM
    from repro_torch.util.device import resolve_device
    dev = resolve_device(device)

    def conv(a):
        return to_torch(a, device=dev)

    port = {}
    for key, sub in tree.items():
        if key not in _STACKS:
            port[key] = _map_tree(sub, conv)
            continue
        groups = sub["groups"]
        if groups is not None:
            n = _leading_dim(groups)
            groups = {pk: [_map_tree(g_tree, lambda a, g=g: conv(
                a[g] if isinstance(a, torch.Tensor) else np.asarray(a)[g]))
                for g in range(n)]
                for pk, g_tree in groups.items()}
        port[key] = {"groups": groups,
                     "tail": [_map_tree(t, conv) for t in sub["tail"]]}
    return LM(cfg, device=dev, params=port)


def _np_copy(t: torch.Tensor) -> np.ndarray:
    return np.array(to_numpy(t), copy=True)


def lm_params_to_numpy(model) -> dict:
    """The reference's nested parameter dict of a port ``LM`` (numpy
    arrays; bf16 as float32): each stack's layers restacked per pattern
    position."""
    out = {}
    for key, sub in model.tree().items():
        if key not in _STACKS:
            out[key] = _map_tree(sub, _np_copy)
            continue
        groups = sub["groups"]
        if groups is not None:
            groups = {pk: _stack_trees([_map_tree(t, _np_copy)
                                        for t in layers])
                      for pk, layers in groups.items()}
        out[key] = {"groups": groups,
                    "tail": [_map_tree(t, _np_copy) for t in sub["tail"]]}
    return out


def lm_caches_to_numpy(cfg, caches) -> dict:
    """The port's per-layer decode caches in the reference's layout
    (``{"groups": {"p{i}": stacked}, "tail": [...]}``), numpy arrays."""
    period = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // period
    layers = [_map_tree(c, _np_copy) for c in caches]
    groups = None
    if n_groups > 0:
        groups = {f"p{i}": _stack_trees([layers[g * period + i]
                                         for g in range(n_groups)])
                  for i in range(period)}
    return {"groups": groups, "tail": layers[n_groups * period:]}


def stack_params(tree) -> dict:
    """The port's per-layer parameter tree (``LM.tree()``) in the
    reference's layout, as tensors: each stack's ``groups["p{i}"]`` layers
    stacked on a new leading group dim (a copy)."""
    out = {}
    for key, sub in tree.items():
        if key not in _STACKS:
            out[key] = sub
            continue
        groups = sub["groups"]
        if groups is not None:
            groups = {pk: _stack_tensors(layers)
                      for pk, layers in groups.items()}
        out[key] = {"groups": groups, "tail": list(sub["tail"])}
    return out


def _stack_tensors(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tensors([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unstack_params(tree) -> dict:
    """The reference's stacked layout (tensors) as the port's per-layer
    tree: group g of ``groups/p{i}`` becomes the views ``leaf[g]``, which
    share the stacked tensors' storage."""
    out = {}
    for key, sub in tree.items():
        if key not in _STACKS:
            out[key] = sub
            continue
        groups = sub["groups"]
        if groups is not None:
            n = _leading_dim(groups)
            groups = {pk: [_map_tree(g_tree, lambda a, g=g: a[g])
                           for g in range(n)]
                      for pk, g_tree in groups.items()}
        out[key] = {"groups": groups, "tail": list(sub["tail"])}
    return out
