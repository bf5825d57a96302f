"""The port's serving path beyond per-architecture parity: the ring buffer
of a local-attention layer, greedy generation, the reference's ring caveat,
and smollm in bf16.

The caveat: the reference's prefill writes a local-attention layer's last
W keys to slots 0..W−1 while its decode writes position t to slot t mod W,
which agree only when the prompt length is a multiple of W.  The port
writes the ring in phase.  At a prompt of 40 tokens (W = 32) the JAX
decode leaves its own forward (> 0.1 scaled) and the port's stays within
tests/test_decode.py's 5e-3; at 32 and 64 the two decodes agree (1e-4).
"""

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
from repro_torch.util.convert import lm_params_from_numpy

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(1)
DECODE_TOL = 5e-3
TOL = 1e-4
#: smollm reduced in bf16 against the JAX package in bf16 on the same bf16
#: weights (each rounds in its own order), scaled
BF16_TOL = 2e-2


def scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _local_cfg(mod):
    return mod.get_reduced_config("recurrentgemma_9b").replace(
        layer_pattern=("local_attn",), n_layers=4)


def test_ring_buffer_window_semantics():
    """The first local-attention layer's ring holds exactly the last W
    tokens' projections, so it is invariant to the prefix beyond the
    window (deeper layers see further: stacked windows); also at a prompt
    that is no multiple of W, where the ring is rotated into phase."""
    cfg = _local_cfg(cb)
    model = LM(cfg, device="cpu", seed=1)
    W = cfg.window
    gen = torch.Generator().manual_seed(0)
    for S in (2 * W, 2 * W + 5):
        toks = torch.randint(0, cfg.vocab, (1, S), generator=gen)
        toks2 = toks.clone()
        toks2[:, :S - W] = torch.randint(0, cfg.vocab, (1, S - W),
                                         generator=gen)
        _, c1 = model.prefill({"tokens": toks}, kv_len=W)
        _, c2 = model.prefill({"tokens": toks2}, kv_len=W)
        assert torch.allclose(c1[0]["self"]["k"], c2[0]["self"]["k"],
                              atol=1e-5)
        assert not torch.allclose(c1[-1]["self"]["k"], c2[-1]["self"]["k"],
                                  atol=1e-5)
        # slot t mod W holds position t: the oldest of the last W here,
        # the newest after a prompt of t + 1 tokens
        t = S - W
        _, one = model.prefill({"tokens": toks[:, :t + 1]}, kv_len=W)
        assert torch.allclose(c1[0]["self"]["k"][:, t % W],
                              one[0]["self"]["k"][:, t % W], atol=1e-6)


def test_greedy_generation_deterministic():
    cfg = cb.get_reduced_config("smollm_135m")
    model = LM(cfg, device="cpu", seed=1)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(0))

    def gen():
        logits, caches = model.prefill({"tokens": toks}, kv_len=64)
        cur = logits[:, -1].argmax(-1)[:, None]
        out = [cur]
        for pos in range(16, 24):
            dl, caches = model.decode_step(caches, cur, pos)
            cur = dl[:, 0].argmax(-1)[:, None]
            out.append(cur)
        return torch.cat(out, 1)

    g1, g2 = gen(), gen()
    assert torch.equal(g1, g2)
    assert g1.shape == (2, 9)


@functools.lru_cache(maxsize=None)
def _local_params():
    return jlm.init_params(_local_cfg(jcb), KEY)


@pytest.mark.parametrize("prompt", [32, 40, 64])
def test_ring_caveat_against_the_reference(prompt):
    """Prefill + 3 decode steps of a local-attention stack (W = 32) in both
    packages from the same params, each against its own full forward."""
    jcfg, cfg = _local_cfg(jcb), _local_cfg(cb)
    W = cfg.window
    params = _local_params()
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    S = prompt + 3
    toks = np.random.default_rng(prompt).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    tt = torch.as_tensor(toks)

    @jax.jit
    def reference(jt):
        full = jlm.forward(params, jcfg, {"tokens": jt})[0]
        _, c = jlm.prefill(params, jcfg, {"tokens": jt[:, :prompt]},
                           kv_len=S)
        steps = []
        for t in range(prompt, S):
            d, c = jlm.decode_step(params, jcfg, c, jt[:, t:t + 1],
                                   jnp.int32(t))
            steps.append(d[:, 0])
        return full, steps

    j_full, j_steps = jax.tree.map(np.asarray, reference(jnp.asarray(toks)))
    with torch.no_grad():
        t_full = model({"tokens": tt})[0].numpy()
    _, tc = model.prefill({"tokens": tt[:, :prompt]}, kv_len=S)
    j_err, t_err, apart = [], [], []
    for t, jd in zip(range(prompt, S), j_steps):
        td, tc = model.decode_step(tc, tt[:, t:t + 1], t)
        td = td[:, 0].numpy()
        j_err.append(scaled(jd, j_full[:, t]))
        t_err.append(scaled(td, t_full[:, t]))
        apart.append(scaled(td, jd))
    assert max(t_err) < DECODE_TOL, t_err
    if prompt % W:
        assert max(j_err) > 0.1, j_err           # the reference's caveat
    else:
        assert max(j_err) < DECODE_TOL, j_err
        assert max(apart) < TOL, apart


def test_smollm_reduced_in_bf16():
    """The port in bf16 against the JAX package in bf16 on the same bf16
    weights (BF16_TOL), and no further from the fp32 forward than 1.5×
    the JAX package's own bf16 distance from it."""
    j32, c32 = jcb.get_reduced_config("smollm_135m"), \
        cb.get_reduced_config("smollm_135m")
    j16 = j32.replace(param_dtype="bfloat16", dtype="bfloat16")
    c16 = c32.replace(param_dtype="bfloat16", dtype="bfloat16")
    p32 = jlm.init_params(j32, KEY)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32)
    toks = np.random.default_rng(0).integers(0, j32.vocab, (2, 35)) \
        .astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    j_fp32 = np.asarray(jax.jit(lambda p, b: jlm.forward(p, j32, b)[0])(
        p32, batch))
    j_bf16 = np.asarray(jax.jit(lambda p, b: jlm.forward(p, j16, b)[0])(
        p16, batch))
    model = lm_params_from_numpy(c16, jax.tree.map(np.asarray, p16),
                                 device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    with torch.no_grad():
        t_bf16 = model({"tokens": torch.as_tensor(toks)})[0]
    assert t_bf16.dtype == torch.float32
    t_bf16 = t_bf16.numpy()
    assert scaled(t_bf16, j_bf16) < BF16_TOL
    assert scaled(t_bf16, j_fp32) <= 1.5 * scaled(j_bf16, j_fp32)


def _bf16_case(arch, pattern=None, n_layers=None, S=35):
    """(JAX fp32 logits, JAX bf16 logits, the port's model on the JAX fp32
    tree cast wholesale to bf16, the tokens) of reduced ``arch`` (its
    pattern and depth replaced where given)."""
    kw = {}
    if pattern is not None:
        kw = {"layer_pattern": pattern, "n_layers": n_layers}
    j32 = jcb.get_reduced_config(arch).replace(**kw)
    c16 = cb.get_reduced_config(arch).replace(
        param_dtype="bfloat16", dtype="bfloat16", **kw)
    j16 = j32.replace(param_dtype="bfloat16", dtype="bfloat16")
    p32 = jlm.init_params(j32, KEY)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32)
    toks = np.random.default_rng(0).integers(0, j32.vocab, (2, S)) \
        .astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    j_fp32 = np.asarray(jax.jit(lambda p, b: jlm.forward(p, j32, b)[0])(
        p32, batch))
    j_bf16 = np.asarray(jax.jit(lambda p, b: jlm.forward(p, j16, b)[0])(
        p16, batch))
    model = lm_params_from_numpy(c16, jax.tree.map(np.asarray, p16),
                                 device="cpu")
    return j_fp32, j_bf16, model, torch.as_tensor(toks)


def _serve_bf16(model, toks, prompt: int) -> list:
    """Prefill ``prompt`` tokens and decode the rest: each step's logits."""
    with torch.no_grad():
        logits, caches = model.prefill({"tokens": toks[:, :prompt]},
                                       kv_len=toks.shape[1])
        out = [logits[:, -1]]
        for t in range(prompt, toks.shape[1]):
            dl, caches = model.decode_step(caches, toks[:, t:t + 1], t)
            out.append(dl[:, 0])
    return out


def test_xlstm_reduced_in_bf16():
    """Reduced xlstm-125m from the JAX fp32 tree cast wholesale to bf16
    (the sLSTM's recurrent blocks R in bf16 against its fp32 state): the
    port's forward runs and sits no further from the JAX fp32 forward than
    1.5× the JAX package's own bf16 distance from it (xLSTM's bf16
    rounding diverges in both packages: 0.1 scaled, not smollm's 2e-2);
    its prefill and decode run and give finite logits."""
    j_fp32, j_bf16, model, toks = _bf16_case("xlstm_125m")
    assert model.dec.groups["p3"][0].cell.rz.dtype == torch.bfloat16
    with torch.no_grad():
        t_bf16 = model({"tokens": toks})[0]
    assert t_bf16.dtype == torch.float32
    t_bf16 = t_bf16.numpy()
    assert np.isfinite(t_bf16).all()
    assert scaled(t_bf16, j_fp32) <= 1.5 * scaled(j_bf16, j_fp32)
    for lg in _serve_bf16(model, toks, 32):
        assert lg.shape == (2, model.cfg.vocab)
        assert bool(torch.isfinite(lg).all())


#: (arch whose reduced config gives the widths, the block kind)
RECURRENT_KINDS = [("recurrentgemma_9b", "rglru"), ("xlstm_125m", "mlstm"),
                   ("xlstm_125m", "slstm")]


@pytest.mark.parametrize("arch,kind", RECURRENT_KINDS,
                         ids=[k for _, k in RECURRENT_KINDS])
def test_recurrent_block_runs_a_bf16_tree(arch, kind):
    """Two layers of one recurrent block kind from a wholesale-bf16 JAX
    tree (every leaf bf16, the fp32 gates, Λ and recurrent blocks too):
    forward, prefill and decode run with no mixed-dtype product, the
    forward within 1.5× the JAX bf16 forward's distance from the JAX fp32
    one (or 1e-2 scaled, where the JAX bf16 forward is closer: both
    round to bf16's 3 digits), every logit finite."""
    j_fp32, j_bf16, model, toks = _bf16_case(arch, (kind,), 2)
    with torch.no_grad():
        t_bf16 = model({"tokens": toks})[0].numpy()
    assert np.isfinite(t_bf16).all()
    assert scaled(t_bf16, j_fp32) <= max(1.5 * scaled(j_bf16, j_fp32), 1e-2)
    steps = _serve_bf16(model, toks, 32)
    assert all(bool(torch.isfinite(lg).all()) for lg in steps)
    # the decode steps against the port's own bf16 forward at their
    # positions
    for t, lg in zip(range(32, toks.shape[1]), steps[1:]):
        assert scaled(lg.numpy(), t_bf16[:, t]) <= 5e-2
