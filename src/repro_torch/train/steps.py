"""Train/serve step factories.  Counterpart of ``repro/train/steps.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function:
forward + backward (each layer group under remat when ``cfg.remat``),
global-norm clip, AdamW / Adafactor / sgd.  It does not write the state
it is given: it returns a new one.

The train state is ``{"params", "opt", "step"}`` in the reference's
layout: ``params`` the reference's nested dict with each stack's
``groups/p{i}`` leaves stacked over the layer groups (``util.convert.
stack_params``), ``opt`` mirroring it (``optim.optimizers``), ``step`` an
int32 scalar.  So the optimizer sees the reference's leaf shapes, and
``checkpoint.save`` / ``restore`` write and read the reference's key
paths.  The step runs an ``LM`` whose per-layer parameters are views of
the stacked leaves, takes each layer's gradient and stacks them again.

Under a mesh (a ``Runtime`` over a ``DeviceMesh`` with named dims, see
``make_runtime``) the state is sharded ZeRO-3 style: every parameter and
optimizer leaf is a DTensor with the rule's placements
(``distributed.sharding``; ``shard_state``), so a rank holds about 1/p of
each sharded leaf.  A step runs the local model on the rank's shard of
the batch (split over the data dims), tensor-parallel over "model"
(``models.transformer.Runtime``): each leaf is gathered to the placements
it is computed with (``sharding.compute_spec``): over the data dims only
for the leaves computed split over "model" (heads, FFN columns,
vocabulary rows, experts), over "model" too for the rest.  Each layer
gathers where it runs (``_GatherOnUse``; inside a remat group the
recompute gathers again, so no gathered layer outlives its group) and its
backward reduce-scatters the gradients, averaged over the data dims and
summed over "model" where a rank's gradient is a partial sum there (a
leaf of which the rank computed its uneven heads' part, among others), to
the rule's placements; the embeddings, final norms and frontends are
gathered once a step.  ``seq_parallel`` splits the residual stream's
sequence over "model" too (``act_btd``).  AdamW and sgd update each
rank's shard (the global norm summed over the shards); Adafactor too, its
row and column statistics summed over the shards
(``_adafactor_sharded``).  The storage placements, and so checkpoints,
are the reference's whatever the compute layout.
"""

from __future__ import annotations


import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shard_rules
from repro_torch.models import lm as lm_lib
from repro_torch.models.lm import LM
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models.transformer import NULL_RT, KVShard, Runtime
from repro_torch.optim.optimizers import (OptConfig, _decay, _factored,
                                          apply_updates,
                                          clip_by_global_norm,
                                          init_opt_state, schedule,
                                          tree_leaves, tree_map)
from repro_torch.util.convert import stack_params, unstack_params



def make_runtime(mesh, *, seq_parallel: bool = False) -> Runtime:
    """The model's runtime over ``mesh`` (None: one device): tensor
    parallelism over its "model" dim, and with ``seq_parallel`` the
    residual stream's sequence split over it as well."""
    if mesh is None:
        return NULL_RT
    return Runtime(mesh=mesh, seq_parallel=seq_parallel)


def init_train_state(cfg: ModelConfig, opt_cfg: OptConfig, seed: int = 0, *,
                     device=None) -> dict:
    """The seeded init of ``LM(cfg, seed=)`` in the reference's stacked
    layout, its optimizer state and step 0, on ``device`` (cuda unless the
    caller asks for the CPU)."""
    params = stack_params(LM(cfg, device=device, seed=seed).tree())
    dev = tree_leaves(params)[0].device
    return {"params": params,
            "opt": init_opt_state(opt_cfg.kind, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_specs(cfg: ModelConfig, opt_cfg: OptConfig) -> dict:
    """The train state's tensors on the ``meta`` device (shapes and
    dtypes, nothing allocated)."""
    params = stack_params(lm_lib.init_params(cfg, 0,
                                             device=torch.device("meta")))
    return {"params": params, "opt": init_opt_state(opt_cfg.kind, params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def state_specs(state_spec, mesh) -> dict:
    """Spec tuples of every state leaf: params by rule; optimizer leaves by
    their own key paths (moments inherit their param's spec, Adafactor's
    statistics match no rule); scalars replicated."""
    return {"params": shard_rules.tree_specs(state_spec["params"], mesh,
                                             ("params",)),
            "opt": shard_rules.tree_specs(state_spec["opt"], mesh, ("opt",)),
            "step": ()}


def state_shardings(state_spec, mesh) -> dict:
    """DTensor placements of every state leaf on ``mesh``."""
    return _zip_specs(
        lambda _t, spec, _path: shard_rules.to_placements(spec, mesh),
        state_spec, state_specs(state_spec, mesh))


def batch_shardings(batch_spec, mesh) -> dict:
    """DTensor placements of every batch leaf: dim 0 over the data axes
    it divides."""
    return {k: shard_rules.to_placements(
        shard_rules.batch_pspec(mesh, v.ndim, batch_dim_size=v.shape[0]),
        mesh) for k, v in batch_spec.items()}


# ------------------------------------------------------ sharded state --

def shard_state(state, mesh) -> dict:
    """Each parameter and optimizer leaf of a whole ``state`` (the same on
    every rank) as a DTensor holding this rank's shard (no
    communication); scalars stay plain tensors."""
    return _reshard(state, state_specs(state, mesh), mesh)


def _zip_specs(fn, tree, specs, path=()):
    """``fn(leaf, spec, key path)`` over a tree and its spec tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, tree[k], specs[k], path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_zip_specs(fn, v, sp, path + (i,))
                for i, (v, sp) in enumerate(zip(tree, specs))]
    return fn(tree, specs, path)


def full_state(state) -> dict:
    """The whole state on every rank (a DTensor leaf all-gathered; a
    collective on a sharded state), e.g. for a checkpoint."""
    return tree_map(_full, state)


def _full(t):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        with torch.no_grad():
            return redistribute(t.to_local(), t.device_mesh, t.placements,
                                [Replicate()] * t.device_mesh.ndim)
    return t


def redistribute(t, mesh, src, dst):
    """``t``, this rank's local tensor of DTensor placements ``src`` on
    ``mesh``, as its local tensor of placements ``dst``: DTensor's
    redistribution, done with ``torch.distributed``'s own collectives over
    the mesh dims' groups (DTensor's functional collectives crash on CUDA
    tensors over gloo, where four processes share one card).  Per mesh
    dim: Partial → Replicate all-reduces, Partial → Shard reduce-scatters,
    Replicate → Shard takes the slice, Shard → Replicate all-gathers.
    Mesh dims that split one tensor dim together split it major first
    (``sharding.local_slices``), so reductions and slices run over the
    mesh dims in order and gathers in reverse."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = mesh.mesh_dim_names
    for i, (a, b) in enumerate(zip(src, dst)):
        if a == b or isinstance(b, Partial):
            continue
        group = mesh.get_group(names[i])
        if isinstance(a, Partial):
            t = (tp_lib.reduce_scatter(t, group, b.dim)
                 if isinstance(b, Shard) else tp_lib.all_sum(t, group))
        elif isinstance(a, Replicate):
            t = tp_lib.own_slice(t, group, b.dim)
    for i in reversed(range(len(names))):
        a, b = src[i], dst[i]
        if isinstance(a, Shard) and a != b:
            if not isinstance(b, Replicate):
                raise ValueError(f"no redistribution of {a} to {b}")
            t = tp_lib.all_gather(t, mesh.get_group(names[i]), a.dim)
    return t


# ------------------------------------------------------------ the step --

def model_of(cfg: ModelConfig, params) -> LM:
    """An ``LM`` over a stacked parameter tree: its per-layer parameters
    are views of the tree's tensors (no copy)."""
    return LM(cfg, params=unstack_params(params))


def _grad_slots(model: LM):
    """(the model's parameters, each one's key path in the stacked tree and
    its group index, None where the leaf is not stacked)."""
    params, slots = [], []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc", "dec") and parts[1] == "groups":
            path, g = (parts[0], "groups", parts[2]) + tuple(parts[4:]), \
                int(parts[3])
        elif parts[0] in ("enc", "dec") and parts[1] == "tail":
            path, g = (parts[0], "tail", int(parts[2])) + tuple(parts[3:]), \
                None
        else:
            path, g = tuple(parts), None
        params.append(p)
        slots.append((path, g))
    return params, slots


def _restack(template, slots, grads):
    """The gradients in the stacked tree's layout (``template``'s)."""
    groups: dict = {}
    out = tree_map(lambda _t: None, template)
    for (path, g), grad in zip(slots, grads):
        if g is None:
            _set(out, path, grad)
        else:
            groups.setdefault(path, {})[g] = grad
    for path, per_group in groups.items():
        _set(out, path, torch.stack([per_group[g]
                                     for g in range(len(per_group))]))
    return out


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _split(batch, n: int) -> list:
    """``batch`` cut into ``n`` equal parts along dim 0."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split into {n} "
                         f"microbatches")
    size = B // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(n)]


def grads_of(cfg, params, batches, *, rt=NULL_RT, runtime_for=None):
    """(loss, metrics of the last microbatch, gradients in the stacked
    layout) of the mean loss over ``batches`` (a list of batches: the
    microbatches); with more than one, the gradients are accumulated in
    fp32 as g/n, as the reference's scan does.  ``runtime_for(leaves,
    slots)``, where given, makes the runtime from the model's parameters
    and their slots (``_grad_slots``)."""
    model = model_of(cfg, params)
    leaves, slots = _grad_slots(model)
    if runtime_for is not None:
        rt = runtime_for(leaves, slots)
    n = len(batches)
    loss_acc, acc, metrics = None, None, None
    for b in batches:
        loss, metrics = model.loss_fn(b, rt=rt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if n == 1:
            return loss.detach(), _detach(metrics), \
                _restack(params, slots, grads)
        grads = [g.float() / n for g in grads]
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        part = loss.detach() / n
        loss_acc = part if loss_acc is None else loss_acc + part
    return loss_acc, _detach(metrics), _restack(params, slots, acc)


def _detach(metrics: dict) -> dict:
    return {k: v.detach() if torch.is_tensor(v) else torch.as_tensor(v)
            for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, rt=NULL_RT,
                    microbatches: int = 1):
    """fwd+bwd+update.  ``microbatches`` > 1 enables gradient accumulation:
    the global batch is split along dim 0 and run microbatch by
    microbatch, so live activation memory scales with the microbatch.
    The loss is the mean over microbatches; ``nll`` and ``aux`` are the
    last microbatch's.  Metrics: ``loss``, ``nll``, ``aux``, ``grad_norm``
    (0-d tensors)."""
    if rt.mesh is not None:
        return _make_sharded_step(cfg, opt_cfg, rt, microbatches)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = grads_of(
            cfg, params, _split(batch, microbatches) if microbatches > 1
            else [batch], rt=rt)
        with torch.no_grad():
            new_params, new_opt, gnorm = apply_updates(
                opt_cfg, grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "nll": metrics["nll"],
                           "aux": metrics["aux"], "grad_norm": gnorm}

    return train_step


def _data_info(mesh, data_axes):
    """(the data dims' groups, their rank count)."""
    names = list(mesh.mesh_dim_names)
    groups = [mesh.get_group(a) for a in data_axes if a in names]
    dp = 1
    for g in groups:
        dp *= dist.get_world_size(g)
    return groups, dp


def _local_rows(batch, mesh):
    """This rank's shard of every batch leaf along dim 0."""
    return {k: shard_rules.local_slice(
        v, shard_rules.batch_pspec(mesh, v.ndim, batch_dim_size=v.shape[0]),
        mesh) for k, v in batch.items()}


def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    t = t.clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _sharded_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of sharded gradients: each leaf's local sum of
    squares summed over the mesh dims that shard it (a replicated copy is
    counted once; one all-reduce per set of dims), then the leaves added
    in the tree's order, as ``optimizers.global_norm`` adds them."""
    names = list(mesh.mesh_dim_names)
    parts, keys = [], []

    def add(g, spec, _path):
        dims = set()
        for axes in spec:
            if axes is not None:
                dims.update((axes,) if isinstance(axes, str) else axes)
        keys.append(tuple(sorted(dims, key=names.index)))
        parts.append(torch.sum(g.float() ** 2))
    _zip_specs(add, grads, specs)
    totals = list(parts)
    for key in sorted(set(keys)):             # the same order on every rank
        idx = [i for i, k in enumerate(keys) if k == key]
        if not key:
            continue
        summed = _sum_over(torch.stack([parts[i] for i in idx]),
                           [mesh.get_group(a) for a in key])
        for j, i in enumerate(idx):
            totals[i] = summed[j]
    return torch.sqrt(sum(totals))


def _placements(spec, path, rt, cfg) -> tuple:
    """(the placements a parameter of storage ``spec`` at ``path`` is
    computed with, those of a rank's gradient of it): "model" as
    ``sharding.compute_spec`` says (split, or whole with a gradient that is
    the same on every rank or a partial sum), the data dims whole for use
    and partial in the gradient (one data shard's)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dim, partial = shard_rules.compute_spec(
        path, spec, cfg, rt.mesh, seq_parallel=rt.sp, tp_axis="model")
    use, src = [], []
    for name in rt.mesh.mesh_dim_names:
        if name == "model" and dim is not None:
            use.append(Shard(dim))
            src.append(Shard(dim))
            continue
        use.append(Replicate())
        src.append(Partial() if name in rt.data_axes
                   or (name == "model" and partial) else Replicate())
    return use, src


def _in_stack(path) -> bool:
    """A leaf of a stack's layers (``enc``/``dec`` ``groups`` or
    ``tail``): gathered on use."""
    return len(path) > 1 and path[0] in ("enc", "dec") \
        and path[1] in ("groups", "tail")


class _GatherOnUse(torch.autograd.Function):
    """A layer's parameter shard gathered to the placements it is computed
    with; backward, its gradient (one data shard's) averaged over the data
    dims and reduce-scattered to the shard.  Inside a remat region the
    gathered tensor is not kept: the recompute gathers it again."""

    @staticmethod
    def forward(ctx, shard, mesh, rule, use, src, dp):
        ctx.mesh, ctx.rule, ctx.src, ctx.dp = mesh, rule, src, dp
        return redistribute(shard, mesh, rule, use)

    @staticmethod
    def backward(ctx, g):
        return (redistribute(g / ctx.dp, ctx.mesh, ctx.src, ctx.rule),
                None, None, None, None, None)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _for_use(t, spec, path, rt, cfg):
    """A parameter leaf as the step computes with it: a stack's layers
    gather on use (their shard, as it is); the rest (embeddings, final
    norms, frontends) gathered now."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor) or _in_stack(path):
        return _local(t)
    with torch.no_grad():
        return redistribute(t.to_local(), rt.mesh, t.placements, _placements(
            spec, "/".join(map(str, path)), rt, cfg)[0])


def _gathering_runtime(rt, leaves, slots, pspecs, dp, cfg):
    """``rt`` with layers that gather their shards on use."""
    mesh = rt.mesh
    info = {}
    for p, (path, g) in zip(leaves, slots):
        if not _in_stack(path):
            continue
        spec = pspecs
        for k in path:
            spec = spec[k]
        if g is not None:
            spec = spec[1:]           # the group dim: never sharded
        use, src = _placements(spec, "/".join(map(str, path)), rt, cfg)
        info[id(p)] = (mesh, shard_rules.to_placements(spec, mesh), use, src,
                       dp)

    def gathered(block):
        out = {n: _GatherOnUse.apply(p, *info[id(p)]) if id(p) in info
               else p for n, p in block._parameters.items()}
        for n, m in block._modules.items():
            out[n] = ([gathered(c) for c in m]
                      if isinstance(m, torch.nn.ModuleList)
                      else gathered(m))
        return out

    return rt.replace(param_fn=gathered)


def sharded_grads(cfg, params, batch, rt, *, microbatches: int = 1):
    """(loss, metrics, gradients) of the mean loss on a mesh (``rt``):
    ``params`` the stacked tree of DTensor shards (a train state's, or
    ``shard_params``'), ``batch`` the whole batch of which this rank runs
    its rows; the gradients rank-local, each leaf this rank's shard of the
    rule's placements (wrap them with ``wrap_shards``); the loss and
    metrics averaged over the data dims (the same on every rank)."""
    from torch.distributed.tensor import DTensor
    mesh = rt.mesh
    dgroups, dp = _data_info(mesh, rt.data_axes)
    pspecs = shard_rules.tree_specs(params, mesh, ("params",))
    batches = [_local_rows(b, mesh) for b in
               (_split(batch, microbatches) if microbatches > 1
                else [batch])]
    run = rt.for_batch(batches[0])

    def reduce_scatter(g, spec, path):
        if _in_stack(path):
            return g                      # reduced by _GatherOnUse
        src = _placements(spec, "/".join(map(str, path)), run, cfg)[1]
        return redistribute(g / dp, mesh, src,
                            shard_rules.to_placements(spec, mesh))

    local = _zip_specs(lambda t, spec, path: _for_use(t, spec, path, run,
                                                      cfg), params, pspecs)
    loss, metrics, grads = grads_of(
        cfg, local, batches,
        runtime_for=lambda leaves, slots: _gathering_runtime(
            run, leaves, slots, pspecs, dp, cfg))
    del local
    with torch.no_grad():
        grads = _zip_specs(reduce_scatter, grads, pspecs)
        loss = _sum_over(loss, dgroups) / dp
        metrics = {k: _sum_over(v.float(), dgroups) / dp
                   for k, v in metrics.items()}
    return loss, metrics, grads


def wrap_shards(tree, like, mesh) -> dict:
    """Rank-local shards of a stacked parameter tree (``sharded_grads``'
    gradients) as DTensors with the placements of ``like`` (the DTensor
    parameters they belong to)."""
    return _wrap(tree, shard_rules.tree_specs(like, mesh, ("params",)),
                 mesh)


def _make_sharded_step(cfg, opt_cfg, rt, microbatches):
    mesh = rt.mesh

    def train_step(state, batch):
        specs = state_specs(state, mesh)
        loss, metrics, grads = sharded_grads(cfg, state["params"], batch, rt,
                                             microbatches=microbatches)
        with torch.no_grad():
            gnorm = _sharded_norm(grads, specs["params"], mesh)
            p_loc = tree_map(_local, state["params"])
            o_loc = tree_map(_local, state["opt"])
            if opt_cfg.kind == "adafactor":
                new_p, new_opt = _adafactor_sharded(
                    opt_cfg, grads, o_loc, p_loc, specs["params"], mesh,
                    norm=gnorm)
            else:
                new_p, new_opt, _ = apply_updates(opt_cfg, grads, o_loc,
                                                  p_loc, norm=gnorm)
            new_p = _wrap(new_p, specs["params"], mesh)
            new_opt = _wrap(new_opt, specs["opt"], mesh)
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "nll": metrics["nll"],
                           "aux": metrics["aux"], "grad_norm": gnorm}

    return train_step


def _adafactor_sharded(cfg, grads, state, params, pspecs, mesh, *, norm):
    """Adafactor on each rank's shards: ``optimizers.adafactor_update``'s
    rule on the whole leaves, computed piecewise.  A factored leaf's row
    and column statistics (and an unfactored leaf's second moment) are
    summed over the ranks holding its shards, so they stay whole and the
    same on every rank, as their specs (replicated) say; the update's RMS
    is taken over the whole leaf.  Returns (new params, new state), both
    rank-local."""
    grads, _ = clip_by_global_norm(grads, cfg.clip_norm, norm=norm)
    c = state["count"] + 1
    lr = schedule(cfg, c)
    beta2 = 1.0 - c.to(torch.float32) ** -0.8       # Shazeer-Stern schedule
    out = tree_map(lambda p, g, v, spec: _adafactor_shard(
        cfg, g, v, p, spec, mesh, beta2, lr), params, grads, state["v"],
        pspecs)
    return (tree_map(lambda _p, t: t[0], params, out),
            {"v": tree_map(lambda _p, t: t[1], params, out), "count": c})


def _adafactor_shard(cfg, g, v, p, spec, mesh, beta2, lr):
    """One leaf of ``_adafactor_sharded``: (new shard, new state dict)."""
    sizes = shard_rules.mesh_shape(mesh)
    names = list(mesh.mesh_dim_names)
    full, axes = list(p.shape), set()
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            full[d] *= sizes[a]
            axes.add(a)
    groups = [mesh.get_group(a) for a in names if a in axes]
    idx = shard_rules.local_slices(full, spec, mesh)

    def summed(part, shape, index):
        # a statistic of this shard, placed in the whole and summed over
        # the leaf's shards
        t = torch.zeros(shape, dtype=torch.float32, device=part.device)
        t[index] = part
        for grp in groups:
            dist.all_reduce(t, group=grp)
        return t

    g32 = g.float()
    g2 = g32 * g32 + cfg.adafactor_eps
    if _factored(full):
        rows = summed(g2.sum(-1), full[:-1], idx[:-1]) / full[-1]
        cols = summed(g2.sum(-2), full[:-2] + full[-1:],
                      idx[:-2] + idx[-1:]) / full[-2]
        del g2
        vr = beta2 * v["vr"] + (1 - beta2) * rows
        vc = beta2 * v["vc"] + (1 - beta2) * cols
        denom = (vr / torch.mean(vr, dim=-1, keepdim=True))[idx[:-1]][
            ..., None] * vc[idx[:-2] + idx[-1:]][..., None, :]
        step = g32 * denom.add_(cfg.adafactor_eps).rsqrt_()
        del denom
        nv = {"vr": vr, "vc": vc}
    else:
        nv = {"v": beta2 * v["v"] + (1 - beta2) * summed(g2, full, idx)}
        del g2
        step = g32 * torch.rsqrt(nv["v"][idx] + cfg.adafactor_eps)
    del g32
    # update clipping (RMS <= 1) over the whole leaf
    sq = torch.sum(step * step)
    for grp in groups:
        dist.all_reduce(sq, group=grp)
    n = 1
    for f in full:
        n *= f
    rms = torch.sqrt(sq / n + 1e-30)
    step.div_(torch.clamp(rms, min=1.0))
    step = _decay(step, p, cfg)
    return (p.float() - lr * step).to(p.dtype), nv


def _wrap(tree, specs, mesh):
    """Local shards as DTensors with their spec's placements."""
    from torch.distributed.tensor import DTensor
    return _zip_specs(
        lambda t, spec, _path: t if t.ndim == 0 else DTensor.from_local(
            t, mesh, shard_rules.to_placements(spec, mesh), run_check=False),
        tree, specs)


def _reshard(tree, specs, mesh):
    """Whole tensors (the same on every rank) as DTensors of this rank's
    shard."""
    return _wrap(_zip_specs(
        lambda t, spec, _path: t if t.ndim == 0 else
        shard_rules.local_slice(t, spec, mesh).contiguous(), tree, specs),
        specs, mesh)


# ------------------------------------------------------- serving steps --

def _model(cfg, params) -> LM:
    return params if isinstance(params, LM) else model_of(cfg, params)


def _serving(cfg, params, rt, batch):
    """(the model, its runtime for ``batch``) for a serving step.  On a
    mesh ``params`` is a stacked tree of DTensor shards
    (``shard_params``): the model runs on this rank's batch rows,
    tensor-parallel over "model", its embeddings, final norms and
    frontends gathered at the call, each layer's parameters where the
    layer runs, as the sharded train step gathers them."""
    if rt.mesh is None:
        return _model(cfg, params), rt
    mesh = rt.mesh
    run = rt.for_batch(batch)
    specs = shard_rules.tree_specs(params, mesh, ("params",))
    model = model_of(cfg, _zip_specs(
        lambda t, spec, path: _for_use(t, spec, path, run, cfg), params,
        specs))
    leaves, slots = _grad_slots(model)
    _, dp = _data_info(mesh, run.data_axes)
    return model, _gathering_runtime(run, leaves, slots, specs, dp, cfg)


def _last_logits(logits, run, vocab: int):
    """The last position's logits over the whole vocabulary, (B, V): the
    rank's vocabulary columns gathered over "model", or, where the
    sequence is split instead, the last rank's last row."""
    last = logits[:, -1:]
    if last.shape[-1] < vocab:
        last = tp_lib.all_gather(last, run.group, 2)
    elif run.sp:
        last = tp_lib.all_gather(last, run.group, 1)[:, -1:]
    return last[:, 0]


def shard_params(params, mesh) -> dict:
    """A whole stacked parameter tree (the same on every rank) as DTensors
    of this rank's shards, by the train state's rules (no
    communication)."""
    return _reshard(params, shard_rules.tree_specs(params, mesh,
                                                   ("params",)), mesh)


def local_caches(caches, mesh, batch: int) -> list:
    """This rank's part of whole decode caches (the same on every rank),
    split as ``cache_shardings`` says: the batch over the data dims and
    the KV length of the attention caches over "model", each such cache a
    ``KVShard`` that knows its first position; and a recurrent state's
    channels or whole heads over "model" where its mixer runs split
    (``sharding.recurrent_cache_slices``: uneven where the heads do not
    divide)."""
    specs = shard_rules.cache_shardings(caches, mesh, batch)
    names = list(mesh.mesh_dim_names)
    tp = mesh.size(names.index("model")) if "model" in names else 1
    rank = mesh.get_local_rank("model") if tp > 1 else 0

    def walk(tree, spec):
        if isinstance(tree, dict):
            out = {k: walk(v, spec[k]) for k, v in tree.items()}
            for k, (d, a, b) in shard_rules.recurrent_cache_slices(
                    tree, tp, rank).items():
                out[k] = out[k].narrow(d, a, b - a).contiguous()
            first = next(iter(tree.values()))
            sp = spec[next(iter(tree))]
            if next(iter(tree)) in ("k", "ek") \
                    and sp[first.ndim - 3] == "model":
                n = first.shape[first.ndim - 3] // tp
                return KVShard(out, start=rank * n,
                               total=first.shape[first.ndim - 3])
            return out
        if isinstance(tree, (list, tuple)):
            return [walk(v, sp) for v, sp in zip(tree, spec)]
        return shard_rules.local_slice(tree, spec, mesh).contiguous()

    return walk(caches, specs)


def make_prefill_step(cfg: ModelConfig, kv_len: int, *, rt=NULL_RT):
    """(params, batch) -> (last-position logits (B, V), caches); ``params``
    an ``LM`` or a stacked parameter tree, on a mesh (``rt``) its DTensor
    shards (``shard_params``) and ``batch`` the whole batch, of which the
    step runs this rank's rows: the logits are those rows' over the whole
    vocabulary, the caches the rank's part."""
    def prefill_step(params, batch):
        if rt.mesh is not None:
            batch = _local_rows(batch, rt.mesh)
        model, run = _serving(cfg, params, rt, batch)
        logits, caches = model.prefill(batch, kv_len, rt=run)
        # return only last-position logits (what serving samples from)
        return _last_logits(logits, run, cfg.vocab), caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, rt=NULL_RT):
    """One decode step for a running batch: (params, caches, tokens, pos)
    -> (last-position logits (B, V) fp32, caches written in place).  On a
    mesh (``rt``) ``params`` are DTensor shards (``shard_params``),
    ``caches`` this rank's (``local_caches``) and ``tokens`` the whole
    batch's; the logits are the rank's rows' over the whole
    vocabulary."""
    def decode_step(params, caches, tokens, pos):
        if rt.mesh is not None:
            tokens = _local_rows({"t": tokens}, rt.mesh)["t"]
        model, run = _serving(cfg, params, rt, {"tokens": tokens})
        logits, caches = model.decode_step(caches, tokens, int(pos),
                                           rt=run)
        return _last_logits(logits, run, cfg.vocab), caches
    return decode_step


def make_serve_step(cfg: ModelConfig, *, rt=NULL_RT):
    """One greedy decode step for a running batch: (params, caches, tokens,
    pos) -> (next_tokens (B, 1) int32, caches written in place), the
    argmax (``torch.argmax``'s tie order) of ``make_decode_step``'s
    logits; on a mesh the rank's rows'."""
    decode = make_decode_step(cfg, rt=rt)

    def serve_step(params, caches, tokens, pos):
        logits, caches = decode(params, caches, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], caches
    return serve_step


def jitted_train_step(cfg, opt_cfg, mesh, *, seq_parallel=False):
    """There is no jit to wrap: (the train step over ``mesh``, the state's
    placements on it)."""
    rt = make_runtime(mesh, seq_parallel=seq_parallel)
    step = make_train_step(cfg, opt_cfg, rt=rt)
    return step, state_shardings(train_state_specs(cfg, opt_cfg), mesh)
