"""Shared by tests/test_torch_train_grads_{a,b}.py and
test_torch_train_ckpt.py (no tests of its own): every reduced
architecture's loss, gradients and train step in both packages, from the
JAX package's parameters and one numpy batch.

The JAX side (``value_and_grad`` of ``lm.loss_fn``, and
``make_train_step`` with adamw at one and two microbatches) runs as one
``jax.jit`` program per arch, once per module (``run``).  The port takes
the same parameters in the reference's stacked layout (the train state's
own) and the same batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import base as cb
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps

KEY = jax.random.PRNGKey(5)
B, S = 4, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
REMAT_TOL = 1e-6


def opt_kw():
    return dict(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10,
                weight_decay=0.1)


def scaled(got, want, floor: float = 0.0) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), floor, 1e-30))


def batch_of(cfg, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][:, -2:] = -1                      # ignored positions
    if cfg.is_encdec:
        batch["enc_frames"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "image_patches":
        batch["img_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _reference(jcfg, batch):
    params = jlm.init_params(jcfg, KEY)
    (loss, parts), grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, batch), has_aux=True)(params)
    opt = jopt.OptConfig(**opt_kw())
    state = {"params": params, "opt": jopt.init_opt_state("adamw", params),
             "step": jnp.zeros((), jnp.int32)}
    out = {"params": params, "loss": loss, "nll": parts["nll"],
           "aux": parts["aux"], "grads": grads}
    for mb in (1, 2):
        st, m = jsteps.make_train_step(jcfg, opt, microbatches=mb)(state,
                                                                   batch)
        out[f"step{mb}"] = {"state": st, "metrics": m}
    return out


def tensors(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def numpy(tree):
    return topt.tree_map(lambda t: t.detach().numpy(), tree)


@functools.lru_cache(maxsize=None)
def run(arch):
    jcfg = jcb.get_reduced_config(arch)
    cfg = cb.get_reduced_config(arch)
    batch = batch_of(cfg)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda b: _reference(jcfg, b))({k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    params = tensors(ref["params"])
    opt = topt.OptConfig(**opt_kw())
    state = {"params": params, "opt": topt.init_opt_state("adamw", params),
             "step": torch.zeros((), dtype=torch.int32)}
    loss, metrics, grads = steps.grads_of(cfg, params, [tb])
    port = {"loss": float(loss), "nll": float(metrics["nll"]),
            "aux": float(metrics["aux"]), "grads": numpy(grads)}
    for mb in (1, 2):
        st, m = steps.make_train_step(cfg, opt, microbatches=mb)(state, tb)
        port[f"step{mb}"] = {"state": numpy(st),
                             "metrics": {k: float(v) for k, v in m.items()}}
    for remat in ("full", "dots"):
        rcfg = cfg.replace(remat=True, remat_policy=remat)
        _, _, g = steps.grads_of(rcfg, params, [tb])
        port[f"remat_{remat}"] = numpy(g)
    return {"cfg": cfg, "ref": ref, "port": port}


#: a gradient leaf whose largest entry is below this share of the whole
#: gradient's is zero up to rounding (a key bias under softmax's shift
#: invariance, mLSTM's input-gate bias under its stabiliser: ≈ 1e-9 of
#: the largest entry in both packages); both packages must keep it there
ZERO_SHARE = 1e-6


def leaf_error(got, want, top: float, tol: float):
    """None if ``got`` holds ``want`` (scaled error within ``tol``; for a
    leaf zero up to rounding, both within ZERO_SHARE · ``top``), else the
    failing measure."""
    want_max = float(np.abs(want).max()) if np.size(want) else 0.0
    if want_max <= ZERO_SHARE * top:
        got_max = float(np.abs(got).max()) if np.size(got) else 0.0
        return None if got_max <= ZERO_SHARE * top else got_max / top
    err = scaled(got, want)
    return None if err <= tol else err


def top_of(tree) -> float:
    return max(float(np.abs(a).max()) for a in jax.tree.leaves(tree))


def pairs(a, b, path=""):
    """(path, leaf a, leaf b) over two nested dicts/lists."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            yield from pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from pairs(x, y, f"{path}/{i}")
    elif a is None:
        assert b is None, path
    else:
        yield path, a, b


def check_loss_and_grads(arch):
    r = run(arch)
    ref, port = r["ref"], r["port"]
    for key in ("loss", "nll"):
        assert abs(port[key] - float(ref[key])) <= LOSS_TOL * abs(
            float(ref[key])), (key, port[key], float(ref[key]))
    assert abs(port["aux"] - float(ref["aux"])) <= LOSS_TOL * max(
        abs(float(ref["aux"])), 1e-3)
    n = 0
    top = top_of(ref["grads"])
    for path, want, got in pairs(ref["grads"], port["grads"]):
        assert got.shape == want.shape, path
        err = leaf_error(got, want, top, GRAD_TOL)
        assert err is None, (path, err)
        n += 1
    assert n == len(jax.tree.leaves(ref["params"]))


def check_train_step(arch, mb: int):
    """One adamw step: the metrics, the moments (linear / quadratic in the
    gradient) and the count against JAX.  The new parameters are held
    where the gradient is well above rounding; elsewhere Adam's first step
    is sign(g)·lr, whose sign rounding may flip, so only its size is."""
    r = run(arch)
    jst, jm = r["ref"][f"step{mb}"]["state"], r["ref"][f"step{mb}"]["metrics"]
    tst, tm = r["port"][f"step{mb}"]["state"], \
        r["port"][f"step{mb}"]["metrics"]
    for key in ("loss", "nll"):
        assert abs(tm[key] - float(jm[key])) <= LOSS_TOL * abs(
            float(jm[key])), key
    assert abs(tm["grad_norm"] - float(jm["grad_norm"])) <= GRAD_TOL * float(
        jm["grad_norm"])
    assert int(tst["step"]) == int(jst["step"]) == 1
    assert int(tst["opt"]["count"]) == int(jst["opt"]["count"]) == 1
    for moment in ("m", "v"):
        top = top_of(jst["opt"][moment])
        share = ZERO_SHARE if moment == "m" else ZERO_SHARE ** 2
        for path, want, got in pairs(jst["opt"][moment], tst["opt"][moment]):
            want_max = float(np.abs(want).max())
            if want_max <= share * top:
                assert float(np.abs(got).max()) <= share * top, (moment,
                                                                 path)
            else:
                assert scaled(got, want) <= 2 * GRAD_TOL, (moment, path)
    check_params(r["ref"]["params"], jst["params"], tst["params"],
                 r["ref"]["grads"], opt_kw()["lr"])


def check_params(before, want_tree, got_tree, grads, lr: float):
    """New parameters against the reference's after one update of size
    ≈ lr per element (Adam, or Adafactor's row/column-normalised step):
    held within 1e-4 of the leaf's scale + 1e-3·lr where the element's
    gradient is at least 1e-2 of its leaf's largest (and the leaf is not
    zero up to rounding); elsewhere the normalised step of a gradient near
    rounding may flip sign, so only its size is held: within lr (Adam's
    largest step, plus weight decay 0.1) or the reference's largest step
    in the leaf (Adafactor's may exceed lr)."""
    top = top_of(grads)
    for path, want, got in pairs(want_tree, got_tree):
        prev = np.asarray(_leaf(before, path))
        g = np.abs(np.asarray(_leaf(grads, path)))
        firm = (g >= 1e-2 * g.max()) & (g.max() > ZERO_SHARE * top)
        diff = np.abs(np.asarray(got, np.float64) - want)
        assert diff[firm].max(initial=0.0) <= 1e-4 * np.abs(want).max() \
            + 1e-3 * lr, path
        step = max(np.abs(np.asarray(want, np.float64) - prev).max(),
                   lr * (1 + 0.1 * np.abs(prev).max()))
        assert np.abs(np.asarray(got, np.float64) - prev).max() \
            <= 1.01 * step, path


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def check_microbatches(arch):
    """Two microbatches against one: the mean gradient over equal halves
    is the full batch's (no MoE: its capacity and router loss are per
    call, in both packages)."""
    r = run(arch)
    check_train_step(arch, 2)
    if r["cfg"].moe.n_experts:
        return
    one, two = r["port"]["step1"], r["port"]["step2"]
    assert abs(one["metrics"]["loss"] - two["metrics"]["loss"]) <= \
        LOSS_TOL * abs(one["metrics"]["loss"])
    top = top_of(one["state"]["opt"]["m"])
    for path, want, got in pairs(one["state"]["opt"]["m"],
                                 two["state"]["opt"]["m"]):
        err = leaf_error(got, want, top, GRAD_TOL)
        assert err is None, (path, err)


def check_remat(arch):
    """Remat recomputes; it changes no gradient (within rounding of the
    recomputed forward)."""
    r = run(arch)
    top = top_of(r["port"]["grads"])
    for policy in ("full", "dots"):
        for path, want, got in pairs(r["port"]["grads"],
                                     r["port"][f"remat_{policy}"]):
            err = leaf_error(got, want, top, REMAT_TOL)
            assert err is None, (policy, path, err)
