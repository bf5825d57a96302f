"""The port's model stack (``repro_torch.models``) against the JAX package
at every architecture's reduced config, fp32 on the CPU: the JAX params go
through ``util.convert.lm_params_from_numpy`` and both take the same numpy
batch.  The JAX side (init, forward, loss, prefill, three decode steps)
runs as one ``jax.jit`` program per arch: eager mode recompiles every
scan at every call, at three times the test's time.

Per architecture: the forward's logits and MoE aux, ``loss_fn``,
``param_count``, the converter's round trip (bit for bit), the seeded
init's tree, the prefill caches layer by layer, three decode steps against
JAX's, and against the port's own forward (tests/test_decode.py's 5e-3).
Tolerances are max |Δ| / max |ref|: 1e-4 against JAX (fp32; the sum
orders differ), 5e-3 for decode against the forward.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro_torch.configs import base as cb
from repro_torch.models.lm import LM
from repro_torch.util.convert import (lm_caches_to_numpy,
                                      lm_params_from_numpy,
                                      lm_params_to_numpy)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(1)
B, P, STEPS = 2, 32, 3
S = P + STEPS
TOL = 1e-4
DECODE_TOL = 5e-3


def _nodrop(cfg):
    """No-drop MoE capacity, as tests/test_decode.py's ``_nodrop``."""
    if cfg.moe.n_experts:
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    return cfg


def scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _batch(cfg, seed=0) -> dict:
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
    """Everything the tests read from the JAX package, as one program."""
    params = jlm.init_params(jcfg, KEY)
    logits, _, aux = jlm.forward(params, jcfg, batch)
    loss, parts = jlm.loss_fn(params, jcfg, batch)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    pre["tokens"] = batch["tokens"][:, :P]
    _, caches = jlm.prefill(params, jcfg, pre, kv_len=S + 5)
    decoded, c = [], caches
    for t in range(P, S):
        dl, c = jlm.decode_step(params, jcfg, c, batch["tokens"][:, t:t + 1],
                                jnp.int32(t))
        decoded.append(dl[:, 0])
    return {"params": params, "logits": logits, "aux": aux, "loss": loss,
            "nll": parts["nll"], "caches": caches, "decode": decoded}


@functools.lru_cache(maxsize=None)
def _run(arch):
    """Both packages on one arch: everything the tests compare."""
    jcfg = _nodrop(jcb.get_reduced_config(arch))
    cfg = _nodrop(cb.get_reduced_config(arch))
    batch = _batch(cfg)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda b: _reference(jcfg, b))({k: jnp.asarray(v)
                                         for k, v in batch.items()}))
    tree = ref.pop("params")
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = {"cfg": cfg, "tree": tree, "model": model,
           "jax_count": sum(np.asarray(a).size
                            for a in jax.tree.leaves(tree))}
    out["jax"] = {"logits": ref["logits"], "aux": float(ref["aux"]),
                  "loss": float(ref["loss"]), "nll": float(ref["nll"]),
                  "caches": ref["caches"], "decode": ref["decode"]}
    with torch.no_grad():
        t_logits, _, t_aux = model(tb)
        t_loss, t_parts = model.loss_fn(tb)
    out["port"] = {"logits": t_logits.numpy(), "aux": float(t_aux),
                   "loss": float(t_loss), "nll": float(t_parts["nll"]),
                   "dtype": t_logits.dtype}
    pre_t = {k: v for k, v in tb.items() if k != "labels"}
    pre_t["tokens"] = tb["tokens"][:, :P]
    _, tc = model.prefill(pre_t, kv_len=S + 5)
    out["port"]["caches"] = lm_caches_to_numpy(cfg, tc)
    td = []
    for t in range(P, S):
        dl, tc = model.decode_step(tc, tb["tokens"][:, t:t + 1], t)
        td.append(dl[:, 0].numpy())
    out["port"]["decode"] = td
    return out


ARCHS = jcb.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    r = _run(arch)
    got, want = r["port"]["logits"], r["jax"]["logits"]
    assert got.shape == (B, S, r["cfg"].vocab)
    assert r["port"]["dtype"] == torch.float32
    assert np.isfinite(got).all()
    assert scaled(got, want) < TOL, (arch, scaled(got, want))
    assert abs(r["port"]["aux"] - r["jax"]["aux"]) <= \
        TOL * max(abs(r["jax"]["aux"]), 1e-6)
    if r["cfg"].moe.n_experts:
        assert r["port"]["aux"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    r = _run(arch)
    for key in ("loss", "nll"):
        got, want = r["port"][key], r["jax"][key]
        assert np.isfinite(got)
        assert abs(got - want) <= TOL * abs(want), (arch, key, got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax(arch):
    r = _run(arch)
    assert r["model"].param_count() == r["jax_count"]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bit_for_bit(arch):
    r = _run(arch)
    back = lm_params_to_numpy(r["model"])
    flat_ref = jax.tree_util.tree_leaves_with_path(r["tree"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (path, got), (_, want) in zip(flat_back, flat_ref):
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, np.asarray(want, np.float32),
                                      err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_seeded_init_has_the_reference_tree(arch):
    """The port's own init: the reference's leaves, shapes and dtypes,
    reproducible from its seed, different for another seed."""
    r = _run(arch)
    cfg = r["cfg"]
    ours = LM(cfg, device="cpu", seed=3)
    flat = jax.tree_util.tree_leaves_with_path(lm_params_to_numpy(ours))
    flat_ref = jax.tree_util.tree_leaves_with_path(r["tree"])
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (path, got), (_, want) in zip(flat, flat_ref):
        assert got.shape == want.shape, path
    sd, carried = ours.state_dict(), r["model"].state_dict()
    assert sd.keys() == carried.keys()
    assert all(sd[k].dtype == carried[k].dtype for k in sd)
    again = LM(cfg, device="cpu", seed=3).state_dict()
    other = LM(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["embed.tok"], other["embed.tok"])


def test_state_dict_keys_are_reference_key_paths():
    r = _run("recurrentgemma_9b")            # 1 group of 3 + a tail of 2
    keys = set(r["model"].state_dict())
    assert "embed.tok" in keys and "unembed" in keys
    assert "dec.groups.p2.0.attn.wq" in keys          # local_attn
    assert "dec.groups.p0.0.lru.lam" in keys
    assert "dec.tail.1.ffn.mlp.wi_up" in keys
    assert "final_norm.scale" in keys
    w = r["tree"]["dec"]["groups"]["p2"]["attn"]["wq"][0]
    np.testing.assert_array_equal(
        r["model"].state_dict()["dec.groups.p2.0.attn.wq"].numpy(), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_jax_layer_by_layer(arch):
    r = _run(arch)
    got, want = r["port"]["caches"], r["jax"]["caches"]
    flat = jax.tree_util.tree_leaves_with_path(got)
    flat_ref = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat] == [p for p, _ in flat_ref]
    for (path, g), (_, w) in zip(flat, flat_ref):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        if "m" in str(path[-1]) and w.size and np.abs(w).max() >= 1e29:
            # the stabiliser states start at -1e30: held to the same scale
            np.testing.assert_allclose(g, w, rtol=TOL, err_msg=str(path))
            continue
        for layer in range(g.shape[0]) if path[0].key == "groups" else [None]:
            gl, wl = (g, w) if layer is None else (g[layer], w[layer])
            if wl.size and np.abs(wl).max() > 0:
                assert scaled(gl, wl) < TOL, (arch, path, layer)
            else:
                np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    r = _run(arch)
    for t, (got, want) in enumerate(zip(r["port"]["decode"],
                                        r["jax"]["decode"])):
        assert scaled(got, want) < TOL, (arch, P + t, scaled(got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_forward(arch):
    r = _run(arch)
    full = r["port"]["logits"]
    for i, got in enumerate(r["port"]["decode"]):
        err = scaled(got, full[:, P + i])
        assert err < DECODE_TOL, (arch, P + i, err)
