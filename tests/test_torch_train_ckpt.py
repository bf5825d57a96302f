"""Train checkpoints across the packages: a train state written by either
package's ``checkpoint.save`` restores in the other, key for key, and
training continues alike.

Reduced smollm with adamw and reduced qwen2 with adafactor, fp32: the
JAX package takes a step and saves; the port restores that directory into
its own state (``init_train_state`` as the template), and both take the
next step on the same batch: the loss within a scaled 1e-5, the optimizer
state within a scaled 1e-4, and the parameters as
tests/test_torch_train_parity.py's ``check_params`` holds them (the
normalised step of a gradient near rounding — under rope, a key bias's
slowest frequencies — may flip sign in either package: only its size is
held there).  The other way, the port's step directory restores in
``repro.checkpoint.restore`` bit for bit.  A bf16 state is left out: numpy reads
ml_dtypes' bfloat16 back as raw ``|V2`` bytes (ROADMAP.md §3), and
the port writes bf16 as float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train_parity as par
from repro.checkpoint import checkpoint as jckpt
from repro.configs import base as jcb
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import base as cb
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps

torch.set_num_threads(1)

CASES = {"smollm_135m": "adamw", "qwen2_72b": "adafactor"}


def _opt(kind, pkg):
    return pkg.OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10,
                         weight_decay=0.1)


def _batches(cfg):
    return [par.batch_of(cfg, seed) for seed in (1, 2)]


@functools.lru_cache(maxsize=None)
def _jax_side(arch, tmp):
    """JAX: init, step 1, save; step 2.  Returns (state after 1, state
    after 2, metrics of 2, the gradient of step 2) as numpy."""
    kind = CASES[arch]
    cfg = jcb.get_reduced_config(arch)
    opt = _opt(kind, jopt)
    step = jax.jit(jsteps.make_train_step(cfg, opt))
    state = jsteps.init_train_state(cfg, opt, jax.random.PRNGKey(2))
    b1, b2 = ({k: jnp.asarray(v) for k, v in b.items()}
              for b in _batches(cfg))
    s1, _ = step(state, b1)
    jckpt.save(s1, 1, tmp)
    s2, m2 = step(s1, b2)
    from repro.models import lm as jlm
    g2 = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, cfg, b2)[0]))(
        s1["params"])
    return (jax.tree.map(np.asarray, s1), jax.tree.map(np.asarray, s2),
            {k: float(v) for k, v in m2.items()},
            jax.tree.map(np.asarray, g2))


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_a_jax_checkpoint_restores_and_continues_in_the_port(arch, tmp_path):
    s1, s2, m2, g2 = _jax_side(arch, str(tmp_path))
    cfg = cb.get_reduced_config(arch)
    opt = _opt(CASES[arch], topt)
    template = steps.init_train_state(cfg, opt, 7, device="cpu")
    restored, step = tckpt.restore(str(tmp_path), template)
    assert step == 1
    # every leaf, bit for bit
    for path, want, got in par.pairs(s1, par.numpy(restored)):
        np.testing.assert_array_equal(got, want, err_msg=path)
    new, m = steps.make_train_step(cfg, opt)(restored,
                                             _tb(_batches(cfg)[1]))
    assert abs(float(m["loss"]) - m2["loss"]) <= par.LOSS_TOL * m2["loss"]
    assert abs(float(m["grad_norm"]) - m2["grad_norm"]) <= \
        par.GRAD_TOL * m2["grad_norm"]
    new = par.numpy(new)
    top = par.top_of(g2)
    noise = {path for path, g, _ in par.pairs(g2, g2)
             if np.abs(g).max() <= par.ZERO_SHARE * top}
    for path, want, got in par.pairs(s2["opt"], new["opt"]):
        if np.asarray(want).dtype.kind in "iu":
            assert int(got) == int(want), path
        elif not any(n in path for n in noise):
            assert par.scaled(got, want) <= par.GRAD_TOL, path
    par.check_params(s1["params"], s2["params"], new["params"], g2, opt.lr)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_a_port_checkpoint_restores_in_jax(arch, tmp_path):
    cfg = cb.get_reduced_config(arch)
    kind = CASES[arch]
    opt = _opt(kind, topt)
    state = steps.init_train_state(cfg, opt, 3, device="cpu")
    state, _ = steps.make_train_step(cfg, opt)(state, _tb(_batches(cfg)[0]))
    tckpt.save(state, 1, str(tmp_path))
    jcfg = jcb.get_reduced_config(arch)
    jopt_cfg = _opt(kind, jopt)
    template = jsteps.init_train_state(jcfg, jopt_cfg, jax.random.PRNGKey(0))
    restored, step = jckpt.restore(str(tmp_path), template)
    assert step == 1
    mine = par.numpy(state)
    theirs = jax.tree.map(np.asarray, restored)
    n = 0
    for path, want, got in par.pairs(mine, theirs):
        np.testing.assert_array_equal(got, want, err_msg=path)
        n += 1
    assert n == len(jax.tree.leaves(template))
    # and JAX trains on from it as the port does
    b2 = _batches(cfg)[1]
    _, jm = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg))(
        restored, {k: jnp.asarray(v) for k, v in b2.items()})
    _, tm = steps.make_train_step(cfg, opt)(state, _tb(b2))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        par.LOSS_TOL * float(jm["loss"])
