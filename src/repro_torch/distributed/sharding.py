"""Sharding rules: parameter path → spec, and spec → DTensor placements.
Counterpart of ``repro/distributed/sharding.py``.

Scheme (MaxText/Megatron conventions, ZeRO-3 style):

  * "fsdp"  — the data axes ("pod", "data"): shards the non-TP dimension of
    every weight (parameters, grads, optimizer state all ~N/p per rank);
    the train step all-gathers them for use and reduce-scatters the
    gradients back — the paper's FAUN panel schedule (core/faun.py).
  * "tp"    — the "model" axis: heads / ffn / vocab / expert dimension.
  * replicated — norms, scalar gates, small biases.

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names (the dim split over each in turn, major first), or None.  Rules
match the "/"-joined parameter path of the port's per-layer layout (the
group index one more element: ``dec/groups/p0/3/attn/wq``); the first
regex wins.  Per-layer leaves carry no scan dimension, so a spec is the
reference's for the stacked leaf without its leading None.
``to_placements`` turns a spec into DTensor placements on a ``DeviceMesh``
with named dims.  A spec is how a leaf is stored; ``compute_spec`` says how
a rank computes with it over "model": split as stored (tensor
parallelism), or gathered whole (attention and xLSTM cells whose heads do
not divide then take the rank's whole heads, ``head_range``).
"""

from __future__ import annotations

import re
from typing import Sequence

import torch

FSDP = "__fsdp__"
TP = "__tp__"

# (path regex, spec template over the *trailing* dims of the leaf)
_RULES: list[tuple[str, tuple]] = [
    (r"embed/tok$",            (TP, FSDP)),       # vocab × d_model
    (r"embed/pos$",            (None, FSDP)),
    (r"unembed$",              (FSDP, TP)),       # d_model × vocab
    # attention
    (r"(attn|xattn)/w[qkv]$",  (FSDP, TP)),
    (r"(attn|xattn)/wo$",      (TP, FSDP)),
    (r"(attn|xattn)/b[qkv]$",  (TP,)),
    (r"(attn|xattn)/bo$",      (None,)),
    # dense MLP / shared expert
    (r"(mlp|shared)/wi(_gate|_up)?$", (FSDP, TP)),
    (r"(mlp|shared)/wo$",      (TP, FSDP)),
    (r"(mlp|shared)/bi$",      (TP,)),
    (r"(mlp|shared)/bo$",      (None,)),
    # MoE experts: E over tp (expert parallelism), D over fsdp
    (r"moe/router$",           (FSDP, None)),
    (r"moe/wi(_gate|_up)$",    (TP, FSDP, None)),
    (r"moe/wo$",               (TP, None, FSDP)),
    # Griffin / xLSTM
    (r"(wy|wgate|wup)$",       (FSDP, TP)),
    (r"(wout|wdown)$",         (TP, FSDP)),
    (r"lru/w[ax]$",            (FSDP, TP)),
    (r"lru/(lam|b[ax])$",      (TP,)),
    (r"conv/w$",               (None, TP)),
    (r"conv/b$",               (TP,)),
    (r"cell/w[qkv]$",          (FSDP, TP)),
    (r"cell/w[if]$",           (FSDP, None)),
    (r"cell/(b[if]|ogate_scale)$", (None,)),
    (r"cell/r[zifo]$",         (None,)),          # sLSTM recurrent: tiny
    (r"ffn_(gate|up)$",        (FSDP, TP)),
    (r"ffn_down$",             (TP, FSDP)),
    (r"(w[zifo])$",            (FSDP, TP)),       # sLSTM input projections
]


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with named dims, or of any
    object with a ``shape`` dict (the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def path_str(path) -> str:
    """A key path (a "/"-joined string, or a sequence of keys and
    indices) as the rules read it."""
    if isinstance(path, str):
        return path
    return "/".join(str(k) for k in path)


def _resolve(template: Sequence, fsdp_axes, tp_axis) -> list:
    out = []
    for t in template:
        if t == FSDP:
            out.append(fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0])
        elif t == TP:
            out.append(tp_axis)
        else:
            out.append(None)
    return out


def _divisible(dim: int, axes, shape: dict) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for a in axes:
        size *= shape[a]
    return dim % size == 0


def param_pspec(path, shape, mesh, *, fsdp_axes=("pod", "data"),
                tp_axis="model") -> tuple:
    """The spec of one per-layer parameter of ``shape`` at ``path``; falls
    back dim by dim to replication where a dim does not divide over its
    axes."""
    mshape = mesh_shape(mesh)
    shape = tuple(shape)
    fsdp_axes = tuple(a for a in fsdp_axes if a in mshape)
    ps = path_str(path)
    for pat, template in _RULES:
        if re.search(pat, ps):
            spec = _resolve(template, fsdp_axes, tp_axis)
            break
    else:
        spec = [None] * len(shape)
    while len(spec) < len(shape):
        spec.insert(0, None)
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    if not shape:
        spec = []
    for i, axes in enumerate(spec):
        if not _divisible(shape[i], axes, mshape):
            spec[i] = None
    return tuple(spec)


#: leaves split over "model" where they are computed: (path regex, the
#: tensor dim counted from the end, what must divide the mesh dim: "heads"
#: (whole query heads), "kv" (whole query and KV heads), "cell" (whole
#: heads of an xLSTM cell: ``n_heads`` of an mLSTM or sLSTM block), "conv"
#: (a recurrent block's conv: the RG-LRU's channels, the mLSTM's on whole
#: heads; the sLSTM's stays whole) or None (the storage spec's split is
#: enough)); a head leaf whose heads do not divide is gathered whole and
#: the rank takes its heads' part (``head_range``)
_TP_COMPUTE: list[tuple[str, int, str | None]] = [
    (r"(attn|xattn)/(wq|bq)$", -1, "heads"),        # column-parallel
    (r"(attn|xattn)/wo$",      -2, "heads"),        # row-parallel
    (r"(attn|xattn)/w[kv]$",   -1, "kv"),
    (r"(attn|xattn)/b[kv]$",   -1, "kv"),
    (r"(mlp|shared)/(wi|wi_gate|wi_up|bi)$", -1, None),
    (r"(mlp|shared)/wo$",      -2, None),
    (r"ffn_(gate|up)$",        -1, None),
    (r"ffn_down$",             -2, None),
    (r"embed/tok$",            -2, None),           # vocabulary-parallel
    (r"unembed$",              -1, None),
    (r"moe/(wi_gate|wi_up|wo)$", -3, None),         # expert-parallel
    # the recurrent mixers: RG-LRU channels, xLSTM heads
    (r"(^|/)(wy|wgate)$",      -1, None),
    (r"lru/(wa|wx|ba|bx|lam)$", -1, None),
    (r"(^|/)wout$",            -2, None),
    (r"conv/[wb]$",            -1, "conv"),
    (r"cell/(w[qkv]|wz|wo)$",  -1, "cell"),
    (r"(^|/)wdown$",           -2, "cell"),
]

#: leaves stored whole over "model" (or split off the heads: the mLSTM's
#: ``wup`` [x_m, z]) of which a head-split xLSTM cell takes the rank's
#: heads' columns: gathered whole, their gradient a partial sum
_TP_SLICED = r"((^|/)wup|cell/(w[if]|b[zifo]|r[zifo]|ogate_scale))$"

_STACK = re.compile(r"(?:^|/)(enc|dec)/(?:groups/p(\d+)|tail/(\d+))/")


def _block_kind(path: str, cfg) -> str | None:
    """The block kind of a stack leaf's path (``dec/groups/p{i}/…`` in
    the stacked layout, ``…/p{i}/{g}/…`` per layer, ``dec/tail/{t}/…``),
    or None off the stacks."""
    m = _STACK.search(path)
    if m is None:
        return None
    pattern = cfg.layer_pattern if m.group(1) == "dec" \
        else cfg.encoder_pattern
    return pattern[int(m.group(2) or m.group(3)) % len(pattern)]


def head_range(n_heads: int, tp: int, rank: int) -> tuple:
    """(h0, h1): the heads h0 … h1 − 1 of ``n_heads`` that rank ``rank``
    of a "model" of ``tp`` ranks computes, whole heads in rank order: the
    first ``n_heads % tp`` ranks take ⌈H/tp⌉, the rest ⌊H/tp⌋ (none where
    H < tp).  Where the heads divide this is the storage split
    (rank · H/tp …)."""
    q, rem = divmod(n_heads, tp)
    h0 = rank * q + min(rank, rem)
    return h0, h0 + q + (rank < rem)


def compute_spec(path, spec: tuple, cfg, mesh, *, seq_parallel=False,
                 tp_axis="model") -> tuple:
    """How a leaf of storage ``spec`` at ``path`` is computed over
    ``tp_axis``: (the tensor dim split over it, or None for whole, and
    whether a rank's gradient of it is a partial sum over ``tp_axis``).

    A leaf of ``_TP_COMPUTE`` keeps its storage split over ``tp_axis``
    (tensor parallelism: each rank computes its heads, FFN columns,
    vocabulary rows, experts or recurrent channels) where that split
    exists and, for attention and the xLSTM cells, falls on whole heads:
    ``n_heads`` divides the axis for the query and output projections and
    the cells, ``n_kv`` too for the key and value ones; an RG-LRU splits
    over its channels, an sLSTM's conv never.  Where the heads do not
    divide, attention and the cells still run on the rank's whole heads
    (``head_range``: uneven, none on some ranks where H < tp): their
    leaves are gathered whole and each rank takes its heads' part, so the
    gradient is a partial sum.  Any other leaf is gathered whole.  A
    whole leaf's gradient is a partial sum when the ranks compute with it
    on different inputs: the leaves a rank takes its heads' part of (the
    attention's and cells' where the heads do not divide, the key and
    value projections of a head-parallel layer whose KV heads do not
    divide, the leaves of ``_TP_SLICED``), and, under sequence
    parallelism, every whole leaf but the MoE router (the norms, residual
    biases and gates see the rank's sequence slice; the layers computed
    whole end on the rank's slice).  The router runs inside the expert
    region, which sums its gradient over the group itself."""
    mshape = mesh_shape(mesh)
    tp = mshape.get(tp_axis, 1)
    if tp == 1:
        return None, False
    ps = path_str(path)
    heads_tp = cfg.n_heads % tp == 0
    kind = _block_kind(ps, cfg)
    cells = kind in ("mlstm", "slstm")
    for pat, dim, need in _TP_COMPUTE:
        if not re.search(pat, ps):
            continue
        d = len(spec) + dim
        stored = d >= 0 and spec[d] == tp_axis
        mlstm_conv = need == "conv" and kind == "mlstm"
        if need == "conv":
            need_ok = kind == "rglru" or (mlstm_conv and heads_tp)
        else:
            need_ok = need is None or (heads_tp and (
                need in ("heads", "cell") or cfg.n_kv % tp == 0))
        if stored and need_ok:
            return d, False
        if pat.startswith("moe/"):     # whole experts: moe_ep sums them
            return None, False
        return None, seq_parallel or mlstm_conv or need in ("heads", "kv",
                                                             "cell")
    if cells and re.search(_TP_SLICED, ps):
        return None, True
    return None, seq_parallel and not ps.endswith("moe/router")


def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (named dims): ``Shard(d)``
    on each mesh dim named at tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    placements = []
    for name in mesh.mesh_dim_names:
        dim = None
        for d, axes in enumerate(spec):
            if axes is None:
                continue
            if name == axes or (isinstance(axes, tuple) and name in axes):
                dim = d
        placements.append(Shard(dim) if dim is not None else Replicate())
    return placements


# ----------------------------------------------------------- activations --

def batch_pspec(mesh, ndim: int, *, fsdp_axes=("pod", "data"),
                batch_dim_size: int | None = None) -> tuple:
    """Batch-sharded activation spec; drops axes the batch can't cover
    (e.g. global_batch=1 long-context cells stay replicated)."""
    mshape = mesh_shape(mesh)
    axes = tuple(a for a in fsdp_axes if a in mshape)
    if batch_dim_size is not None:
        keep = []
        prod = 1
        for a in axes:
            if batch_dim_size % (prod * mshape[a]) == 0:
                keep.append(a)
                prod *= mshape[a]
        axes = tuple(keep)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    return (first,) + (None,) * (ndim - 1)


def make_constraint_fn(mesh, *, fsdp_axes=("pod", "data"), tp_axis="model",
                       seq_parallel: bool = False):
    """The reference's activation constraints as specs: a function
    ``(shape, kind) -> spec`` (None for a kind that is not constrained):
    batch over the data axes, "act_btd" sequence-parallel over ``tp_axis``
    when ``seq_parallel``, "act_btv" vocabulary over it, dims that do not
    divide replicated.  ``models.transformer.Runtime.shard`` applies them
    to rank-local activations."""
    mshape = mesh_shape(mesh)
    axes = tuple(a for a in fsdp_axes if a in mshape)
    bspec = axes if len(axes) > 1 else (axes[0] if axes else None)
    specs = {
        "act_btd": (bspec, tp_axis if seq_parallel else None, None),
        "act_btv": (bspec, None, tp_axis),
    }

    def constraint_spec(shape, kind):
        spec = specs.get(kind)
        if spec is None:
            return None
        return tuple(ax if _divisible(dim, ax, mshape) else None
                     for dim, ax in zip(shape, spec))

    return constraint_spec


def cache_shardings(caches, mesh, batch: int, *, fsdp_axes=("pod", "data"),
                    tp_axis="model"):
    """Decode-cache specs, one dict per layer as the caches are: batch over
    fsdp where divisible; the KV length dimension of attention caches
    (k, v, ek, ev) over tp (sequence-parallel KV)."""
    mshape = mesh_shape(mesh)
    axes = tuple(a for a in fsdp_axes if a in mshape)
    baxes = axes if len(axes) > 1 else (axes[0] if axes else None)

    def leaf_spec(path: str, leaf) -> tuple:
        spec = [None] * leaf.ndim
        if baxes is not None:
            for i, d in enumerate(leaf.shape):
                if d == batch and _divisible(d, baxes, mshape):
                    spec[i] = baxes
                    break
        if re.search(r"/(k|v|ek|ev)$", path) and leaf.ndim >= 3:
            ldim = leaf.ndim - 3          # (..., B, L, KH, hd)
            if spec[ldim] is None and _divisible(leaf.shape[ldim], tp_axis,
                                                 mshape):
                spec[ldim] = tp_axis
        return tuple(spec)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return leaf_spec(path, tree)

    return [walk(c, str(layer)) for layer, c in enumerate(caches)]


def recurrent_cache_slices(layer, tp: int, rank: int) -> dict:
    """{leaf: (its dim over "model", start, stop)}: rank ``rank``'s part of
    one recurrent layer's whole decode cache (a dict of tensors) where
    its mixer runs split over a "model" of ``tp`` ranks
    (``compute_spec``): an RG-LRU's ``h`` and ``conv`` on its 1/tp of the
    channels where they divide; an mLSTM's ``C``, ``n``, ``m`` on its
    heads (``head_range``, uneven where they do not divide) and its
    ``conv`` on their channels; an sLSTM's ``c``, ``n``, ``h``, ``m`` on
    its heads (its conv whole); {} for any other layer.  The reference's
    ``cache_shardings`` keeps these states replicated over "model" (GSPMD
    reshards them every step); the port's decode caches hold the rank's
    part (``train.steps.local_caches``)."""
    if tp == 1 or not isinstance(layer, dict):
        return {}
    if "C" in layer or "c" in layer:                   # mLSTM, sLSTM
        H = (layer["C"] if "C" in layer else layer["c"]).shape[1]
        h0, h1 = head_range(H, tp, rank)
        if "c" in layer:
            return {k: (1, h0, h1) for k in ("c", "n", "h", "m")}
        dh = layer["conv"].shape[2] // H
        return {"C": (1, h0, h1), "n": (1, h0, h1), "m": (1, h0, h1),
                "conv": (2, h0 * dh, h1 * dh)}
    if "h" in layer and "conv" in layer:                 # RG-LRU
        width = layer["h"].shape[1]
        if width % tp:
            return {}
        n = width // tp
        return {"h": (1, rank * n, (rank + 1) * n),
                "conv": (2, rank * n, (rank + 1) * n)}
    return {}


def tree_specs(tree, mesh, prefix=(), **kw):
    """The spec of every leaf of a train-state tree in the reference's
    stacked layout (``train.steps``; ``prefix`` the tree's own key path,
    e.g. ``("opt", "m")``): ``param_pspec`` of the leaf's key path and
    shape, as the reference's ``state_shardings`` computes it.  A stacked
    ``groups/p{i}`` leaf gets a leading None for its group dim (no rule
    reads the group index), and an optimizer leaf the spec its own path
    gives (``m`` / ``v`` their parameter's; Adafactor's ``vr`` / ``vc`` /
    ``v`` none)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_specs(v, mesh, prefix + (str(k),), **kw)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_specs(v, mesh, prefix + (str(i),), **kw)
                for i, v in enumerate(tree)]
    return param_pspec(prefix, tree.shape, mesh, **kw)


def local_slices(shape, spec: tuple, mesh) -> tuple:
    """The index (one slice per dim) of this rank's shard of a whole
    tensor of ``shape`` under ``spec``."""
    mshape = mesh_shape(mesh)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = []
    for d, axes in enumerate(spec):
        if axes is None:
            out.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        idx, n = 0, 1
        for a in axes:
            idx = idx * mshape[a] + coord[names.index(a)]
            n *= mshape[a]
        size = shape[d] // n
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of a whole tensor ``t`` under ``spec`` (a view;
    no communication)."""
    for d, sl in enumerate(local_slices(t.shape, spec, mesh)):
        if sl != slice(None):
            t = t.narrow(d, sl.start, sl.stop - sl.start)
    return t
