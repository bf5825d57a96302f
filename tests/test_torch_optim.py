"""The port's optimizers (``repro_torch.optim.optimizers``) against the
JAX package's, on identical gradients.

The parameters of reduced smollm (stacked norm leaves: ``dec/groups/p0/
norm1/scale`` is (3, 72)) and reduced dbrx (3-D expert leaves, stacked
norm biases) go to both packages as the same numpy trees, in the
reference's stacked layout, with the same numpy gradients; adamw,
adafactor and sgd with weight decay 0.1 run one and three
``apply_updates`` steps.  A per-layer optimizer would decay no norm leaf
and factor none, so these leaves tell the two apart.  Tolerance: max |Δ| /
max |ref| ≤ 1e-6 for every parameter and state leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)

TOL = 1e-6
KINDS = ("adamw", "adafactor", "sgd")
ARCHS = ("smollm_135m", "dbrx_132b")


def scaled(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@functools.lru_cache(maxsize=None)
def _params(arch):
    params = jlm.init_params(jcb.get_reduced_config(arch),
                             jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, params)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32),
        params)


def _t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda t: np.asarray(t), tree)


def _cfg(kind):
    # warmup 2 of 10: steps 1-3 cross the warmup into the cosine
    return dict(kind=kind, lr=1e-2, warmup_steps=2, total_steps=10,
                weight_decay=0.1, clip_norm=1.0)


@functools.lru_cache(maxsize=None)
def _run(arch, kind, steps):
    params = _params(arch)
    jcfg = jopt.OptConfig(**_cfg(kind))
    tcfg = topt.OptConfig(**_cfg(kind))
    jp, js = params, jopt.init_opt_state(kind, params)
    tp = _t(params)
    ts = topt.init_opt_state(kind, tp)
    jstep = jax.jit(functools.partial(jopt.apply_updates, jcfg))
    for i in range(steps):
        g = _grads(params, 10 * steps + i)
        jp, js, jgn = jstep(g, js, jp)
        tp, ts, tgn = topt.apply_updates(tcfg, _t(g), ts, tp)
    return (jax.tree.map(np.asarray, (jp, js, jgn)),
            (jax.tree.map(lambda t: t.numpy(), (tp, ts)), float(tgn)))


def _pairs(a, b, path=""):
    """(path, leaf a, leaf b) over two nested dicts/lists."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    elif a is None:
        assert b is None, path
    else:
        yield path, a, b


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_updates_matches_jax(arch, kind, steps):
    (jp, js, jgn), ((tp, ts), tgn) = _run(arch, kind, steps)
    assert abs(tgn - float(jgn)) <= TOL * float(jgn)
    n = 0
    for path, want, got in _pairs(jp, tp, "params"):
        assert got.shape == want.shape, path
        assert scaled(got, want) <= TOL, (path, scaled(got, want))
        n += 1
    for path, want, got in _pairs(js, ts, "opt"):
        assert np.shape(got) == np.shape(want), path
        if np.asarray(want).dtype.kind in "iu":
            assert int(got) == int(want), path
        else:
            assert scaled(got, want) <= TOL, (path, scaled(got, want))
    assert n == len(jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_leaves_follow_the_reference_rules(arch):
    """Weight decay reaches the stacked norm leaves, and Adafactor factors
    them (a ``vc`` shared across the group's layers), as in the
    reference."""
    params = _params(arch)
    scale = params["dec"]["groups"]["p0"]["norm1"]["scale"]
    assert scale.ndim == 2 and scale.shape[0] > 1
    st = topt.init_opt_state("adafactor", _t(params))
    leaf = st["v"]["dec"]["groups"]["p0"]["norm1"]["scale"]
    assert set(leaf) == {"vr", "vc"}
    assert tuple(leaf["vr"].shape) == scale.shape[:1]
    assert tuple(leaf["vc"].shape) == scale.shape[1:]
    # sgd-free check of decay: zero gradients still move a stacked scale
    cfg = topt.OptConfig(kind="adamw", lr=1e-2, warmup_steps=0,
                         total_steps=10, weight_decay=0.1)
    tp = _t(params)
    tp["dec"]["groups"]["p0"]["norm1"]["scale"] = torch.ones(scale.shape)
    zero = topt.tree_map(torch.zeros_like, tp)
    new, _, _ = topt.apply_updates(cfg, zero, topt.init_opt_state("adamw", tp),
                                   tp)
    moved = new["dec"]["groups"]["p0"]["norm1"]["scale"]
    assert float(moved.max()) < 1.0


@pytest.mark.parametrize("step", [0, 1, 2, 5, 10, 20])
def test_schedule_matches_jax(step):
    for warm, total in ((0, 10), (2, 10), (10, 10), (100, 10_000)):
        kw = dict(lr=3e-4, warmup_steps=warm, total_steps=total)
        want = float(jopt.schedule(jopt.OptConfig(**kw), jnp.int32(step)))
        got = float(topt.schedule(topt.OptConfig(**kw),
                                  torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-7 * max(abs(want), 1e-12), (warm, total)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _grads(_params("smollm_135m"), 7)
    jg, jn = jax.jit(functools.partial(jopt.clip_by_global_norm,
                                       max_norm=max_norm))(g)
    tg, tn = topt.clip_by_global_norm(_t(g), max_norm)
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    for path, want, got in _pairs(_np(jg), jax.tree.map(
            lambda t: t.numpy(), tg)):
        assert scaled(got, want) <= TOL, path
