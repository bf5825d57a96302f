"""The model stack's layers on the CPU: attention, the recurrent cells and
MoE routing, each against the JAX package on the same numpy inputs (fp32,
max |Δ| / max |ref| below 1e-5 unless a test says otherwise), plus the
eight cases of tests/test_recurrent.py on the port's own cells.

The RG-LRU scan is a Hillis–Steele scan where the reference runs
``lax.associative_scan``: the products associate in another order, so
the two agree to fp32 rounding (1e-5 scaled), not bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.configs import base as jcb
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro_torch.configs import base as cb
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import recurrent as rec

torch.set_num_threads(1)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def scaled(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _t(tree):
    """A JAX param dict as torch tensors (what ``lm_params_from_numpy``
    does leaf by leaf)."""
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# ---------------------------------------------------------------- attention

ATTN_CASES = {
    "causal": dict(causal=True, q_chunk=16, kv_chunk=16),
    "causal_skip": dict(causal=True, q_chunk=16, kv_chunk=16,
                        causal_skip=True),
    "window_band": dict(causal=True, window=24, q_chunk=16, kv_chunk=16),
    "bidirectional": dict(causal=False, q_chunk=16, kv_chunk=32),
    "softcap": dict(causal=True, q_chunk=32, kv_chunk=16, softcap=5.0),
    "kv_valid": dict(causal=False, q_chunk=16, kv_chunk=16, kv_valid=41),
}


HEADS = {"gqa": (4, 2), "mqa": (4, 1), "mha": (4, 4)}


@pytest.mark.parametrize("case,heads", [(c, "gqa") for c in ATTN_CASES]
                         + [("causal", "mqa")])
def test_blockwise_attention_matches_jax(case, heads):
    H, KH = HEADS[heads]
    B, S, hd = 2, 64, 8
    q, k, v = (_normal(i, B, S, n, hd) * 2 for i, n in
               enumerate((H, KH, KH)))
    kw = ATTN_CASES[case]
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    got = attn.blockwise_attention(torch.as_tensor(q), torch.as_tensor(k),
                                   torch.as_tensor(v), **kw)
    assert got.shape == (B, S, H, hd)
    assert scaled(got, want) < TOL, scaled(got, want)


def test_dense_attention_matches_jax():
    """The decode step's form: one query over a cache, a valid prefix."""
    B, S, H, KH, hd = 2, 24, 4, 2, 8
    kw = dict(causal=False, q_offset=0, kv_valid=13, softcap=3.0)
    q, k, v = _normal(0, B, 1, H, hd), _normal(1, B, S, KH, hd), \
        _normal(2, B, S, KH, hd)
    want = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    got = attn.dense_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), **kw)
    assert scaled(got, want) < TOL


def test_causal_skip_matches_baseline():
    """Skipping above-diagonal chunks is numerically the masked baseline,
    values and gradients (tests/test_models.py's case)."""
    gen = torch.Generator().manual_seed(3)
    B, S, H, KH, hd = 2, 128, 4, 2, 16
    q = torch.randn((B, S, H, hd), generator=gen, requires_grad=True)
    k = torch.randn((B, S, KH, hd), generator=gen)
    v = torch.randn((B, S, KH, hd), generator=gen)
    base = attn.blockwise_attention(q, k, v, causal=True, q_chunk=32,
                                    kv_chunk=32)
    skip = attn.blockwise_attention(q, k, v, causal=True, q_chunk=32,
                                    kv_chunk=32, causal_skip=True)
    assert float((base - skip).detach().abs().max()) < 1e-5
    g1, = torch.autograd.grad((base ** 2).sum(), q)
    g2, = torch.autograd.grad((skip ** 2).sum(), q)
    assert float((g1 - g2).abs().max()) < 1e-4


def test_qkv_matches_jax():
    jcfg = jcb.get_reduced_config("granite_20b")          # biases, MQA
    cfg = cb.get_reduced_config("granite_20b")
    p = jattn.init_attn(KEY, jcfg)
    x, ctx = _normal(0, 2, 5, cfg.d_model), _normal(1, 2, 7, cfg.d_model)
    for c in (None, ctx):
        want = jattn.qkv(p, jnp.asarray(x), jcfg,
                         None if c is None else jnp.asarray(c))
        got = attn.qkv(_t(p), torch.as_tensor(x), cfg,
                       None if c is None else torch.as_tensor(c))
        for g, w in zip(got, want):
            assert g.shape == w.shape and scaled(g, w) < TOL


def test_blockwise_refuses_ragged_chunks():
    q = torch.zeros((1, 30, 2, 4))
    with pytest.raises(ValueError, match="multiples"):
        attn.blockwise_attention(q, q, q, causal=True, q_chunk=16,
                                 kv_chunk=16)


# --------------------------------------------- recurrent: the reference's 8

def test_conv1d_causal_matches_decode():
    p = rec.init_conv1d(0, 8, 4, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(1, 2, 10, 8))
    y_full, state = rec.conv1d_causal(p, x)
    st_ = torch.zeros((2, 3, 8))
    ys = []
    for t in range(10):
        yt, st_ = rec.conv1d_causal(p, x[:, t:t + 1], st_)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1), y_full, atol=1e-5)
    np.testing.assert_allclose(st_, state, atol=1e-6)


def test_rglru_scan_matches_step():
    dim = 16
    p = rec.init_rglru(0, dim, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(2, 3, 12, dim))
    y, h_last = rec.rglru_scan(p, x)
    h = torch.zeros((3, dim))
    ys = []
    for t in range(12):
        yt, h = rec.rglru_step(p, x[:, t], h)
        ys.append(yt[:, None])
    np.testing.assert_allclose(torch.cat(ys, 1), y, atol=1e-4)
    np.testing.assert_allclose(h, h_last, atol=1e-4)


def test_rglru_carried_state():
    dim = 8
    p = rec.init_rglru(0, dim, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(3, 2, 16, dim))
    y_full, _ = rec.rglru_scan(p, x)
    y1, h1 = rec.rglru_scan(p, x[:, :8])
    y2, _ = rec.rglru_scan(p, x[:, 8:], h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1), y_full, atol=1e-4)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mlstm_chunked_matches_step(chunk):
    H, din, S, B = 2, 32, 16, 2
    p = rec.init_mlstm_cell(0, din, H, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(4, B, S, din))
    y_chunk, (C, n, m) = rec.mlstm_chunked(p, x, H, chunk=chunk)
    state = (torch.zeros((B, H, din // H, din // H)),
             torch.zeros((B, H, din // H)), torch.full((B, H), -1e30))
    ys = []
    for t in range(S):
        yt, state = rec.mlstm_step(p, x[:, t], H, state)
        ys.append(yt[:, None])
    np.testing.assert_allclose(torch.cat(ys, 1), y_chunk, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(state[0], C, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state[2], m, rtol=1e-3, atol=1e-3)


def test_mlstm_ragged_length_padding():
    """S not divisible by chunk gives the same result (state-safe pad)."""
    H, din, B = 2, 16, 2
    p = rec.init_mlstm_cell(0, din, H, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(5, B, 13, din))
    y1, st1 = rec.mlstm_chunked(p, x, H, chunk=8)
    y2, st2 = rec.mlstm_chunked(p, x, H, chunk=13)
    np.testing.assert_allclose(y1, y2, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st1[0], st2[0], rtol=2e-3, atol=2e-3)


def test_slstm_scan_matches_step():
    H, din, S, B = 2, 16, 10, 2
    p = rec.init_slstm_cell(0, din, H, torch.float32, device="cpu")
    x = torch.as_tensor(_normal(6, B, S, din))
    y_full, _ = rec.slstm_scan(p, x, H)
    state = None
    ys = []
    for t in range(S):
        yt, state = rec.slstm_step(p, x[:, t], H, state)
        ys.append(yt[:, None])
    np.testing.assert_allclose(torch.cat(ys, 1), y_full, atol=1e-4)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10 ** 6))
def test_rglru_stability_property(seed):
    """|a| < 1 by construction -> bounded outputs for bounded inputs."""
    dim = 8
    p = rec.init_rglru(seed, dim, torch.float32, device="cpu")
    x = torch.clamp(torch.as_tensor(_normal(seed + 1, 1, 200, dim)), -3, 3)
    y, _ = rec.rglru_scan(p, x)
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) < 100.0


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10 ** 6))
def test_mlstm_stability_property(seed):
    H, din = 2, 16
    p = rec.init_mlstm_cell(seed, din, H, torch.float32, device="cpu")
    x = torch.clamp(torch.as_tensor(_normal(seed + 1, 1, 64, din)) * 3,
                    -5, 5)
    y, _ = rec.mlstm_chunked(p, x, H, chunk=16)
    assert bool(torch.isfinite(y).all())


# ------------------------------------------------ recurrent: against JAX

def test_conv1d_and_rglru_match_jax():
    dim = 16
    pc = jrec.init_conv1d(KEY, dim, 4, jnp.float32)
    pl = jrec.init_rglru(jax.random.fold_in(KEY, 1), dim, jnp.float32)
    x, h0 = _normal(0, 2, 37, dim), _normal(1, 2, dim)
    yj, sj = jax.jit(jrec.conv1d_causal)(pc, jnp.asarray(x))
    yt, stt = rec.conv1d_causal(_t(pc), torch.as_tensor(x))
    assert scaled(yt, yj) < TOL and scaled(stt, sj) < TOL
    st_j, st_t = jnp.asarray(x[:, :3]), torch.as_tensor(x[:, :3])
    yj, _ = jrec.conv1d_causal(pc, jnp.asarray(x[:, 5:6]), st_j)
    yt, _ = rec.conv1d_causal(_t(pc), torch.as_tensor(x[:, 5:6]), st_t)
    assert scaled(yt, yj) < TOL
    scan = jax.jit(jrec.rglru_scan)
    for h in (None, h0):
        yj, hj = scan(pl, jnp.asarray(x),
                      h0=None if h is None else jnp.asarray(h))
        yt, ht = rec.rglru_scan(_t(pl), torch.as_tensor(x),
                                h0=None if h is None else torch.as_tensor(h))
        assert scaled(yt, yj) < TOL and scaled(ht, hj) < TOL
    yj, hj = jax.jit(jrec.rglru_step)(pl, jnp.asarray(x[:, 0]),
                                      jnp.asarray(h0))
    yt, ht = rec.rglru_step(_t(pl), torch.as_tensor(x[:, 0]),
                            torch.as_tensor(h0))
    assert scaled(yt, yj) < TOL and scaled(ht, hj) < TOL


@pytest.mark.parametrize("S,chunk", [(32, 8), (13, 8), (16, 16)])
def test_mlstm_matches_jax(S, chunk):
    H, din, B = 2, 32, 2
    p = jrec.init_mlstm_cell(KEY, din, H, jnp.float32)
    x = _normal(S, B, S, din)
    yj, sj = jax.jit(jrec.mlstm_chunked, static_argnums=2,
                     static_argnames="chunk")(p, jnp.asarray(x), H,
                                              chunk=chunk)
    yt, stt = rec.mlstm_chunked(_t(p), torch.as_tensor(x), H, chunk=chunk)
    assert scaled(yt, yj) < 1e-4
    for g, w in zip(stt, sj):
        assert scaled(g, w) < 1e-4
    yj, sj = jax.jit(jrec.mlstm_step, static_argnums=2)(
        p, jnp.asarray(x[:, 0]), H, sj)
    yt, stt = rec.mlstm_step(_t(p), torch.as_tensor(x[:, 0]), H, stt)
    assert scaled(yt, yj) < 1e-4
    for g, w in zip(stt, sj):
        assert scaled(g, w) < 1e-4


def test_slstm_matches_jax():
    H, din, S, B = 2, 16, 12, 2
    p = jrec.init_slstm_cell(KEY, din, H, jnp.float32)
    x = _normal(7, B, S, din)
    yj, sj = jax.jit(jrec.slstm_scan, static_argnums=2)(p, jnp.asarray(x), H)
    yt, stt = rec.slstm_scan(_t(p), torch.as_tensor(x), H)
    assert scaled(yt, yj) < TOL
    for g, w in zip(stt, sj):
        assert scaled(g, w) < TOL
    yj, _ = jax.jit(jrec.slstm_step, static_argnums=2)(
        p, jnp.asarray(x[:, 0]), H, sj)
    yt, _ = rec.slstm_step(_t(p), torch.as_tensor(x[:, 0]), H, stt)
    assert scaled(yt, yj) < TOL


# ------------------------------------------------------------------- MoE

def _moe_cfgs(arch, capacity_factor=None):
    jcfg, cfg = jcb.get_reduced_config(arch), cb.get_reduced_config(arch)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


def test_routing_and_positions_match_jax():
    jcfg, cfg = _moe_cfgs("dbrx_132b")
    p = jmoe.init_moe(KEY, jcfg)
    x = _normal(0, 40, cfg.d_model)
    ij, wj, aj, zj = jax.jit(jmoe._route, static_argnums=2)(
        p["router"], jnp.asarray(x), jcfg)
    it, wt, at, zt = moe._route(_t(p)["router"], torch.as_tensor(x), cfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert scaled(wt, wj) < TOL
    assert abs(float(at) - float(aj)) <= TOL * abs(float(aj))
    assert abs(float(zt) - float(zj)) <= TOL * abs(float(zj))
    flat = np.asarray(ij).reshape(-1)
    np.testing.assert_array_equal(
        moe._positions_in_expert(torch.as_tensor(flat.copy()), 4).numpy(),
        np.asarray(jmoe._positions_in_expert(jnp.asarray(flat), 4)))


def test_top_k_breaks_ties_as_lax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]],
                     np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(probs), 2)
    from repro_torch.util.order import top_k
    vt, it = top_k(torch.as_tensor(probs), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("arch,cf,dropless", [
    ("dbrx_132b", 0.5, False),            # capacity below demand: drops
    ("dbrx_132b", 2.0, False),
    ("llama4_maverick", 0.5, False),      # shared expert, drops
    ("llama4_maverick", 2.0, True),       # decode's dropless capacity
])
def test_moe_local_matches_jax(arch, cf, dropless):
    jcfg, cfg = _moe_cfgs(arch, cf)
    p = jmoe.init_moe(KEY, jcfg)
    x = _normal(1, 2, 24, cfg.d_model)
    yj, aj = jax.jit(jmoe.moe_local, static_argnums=2,
                     static_argnames="dropless")(p, jnp.asarray(x), jcfg,
                                                 dropless=dropless)
    yt, at = moe.moe_local(_t(p), torch.as_tensor(x), cfg, dropless=dropless)
    assert scaled(yt, yj) < 1e-4
    assert abs(float(at) - float(aj)) <= 1e-4 * abs(float(aj))
    if cf < 1:
        # some assignment was dropped: capacity below demand
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        capacity = max(int(2 * 24 * K * cf / E), 1)
        idx, *_ = moe._route(_t(p)["router"],
                             torch.as_tensor(x.reshape(-1, cfg.d_model)), cfg)
        pos = moe._positions_in_expert(idx.reshape(-1), E)
        assert bool((pos >= capacity).any())


def test_moe_ep_and_a_mesh_runtime_name_item_12b():
    """Item 12b landed both: a ``Runtime`` over a mesh with a "model" dim
    runs the MoE layers through ``moe_ep``, which on one rank agrees with
    ``moe_local`` (tests/test_torch_train_dist.py and
    tests/test_torch_moe_ep.py hold it on four)."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models.transformer import Runtime, _apply_ffn
    from repro_torch.util import dist as rdist
    cfg = cb.get_reduced_config("dbrx_132b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    p = moe.init_moe(3, cfg, device="cpu")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    with rdist.one_rank_group(torch.device("cpu")):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rt = Runtime(mesh=mesh)
        assert rt.ep_axis == "model" and rt.data_axes == ("data",)
        y_ep, aux_ep = _apply_ffn({"moe": p}, x, cfg, rt=rt)
        y_dir, _ = moe.moe_ep(p, x, cfg, mesh)
    y_loc, aux_loc = moe.moe_local(p, x, cfg)
    assert torch.equal(y_ep, y_dir)
    assert scaled(y_ep, y_loc) < 1e-6
    assert abs(float(aux_ep) - float(aux_loc)) <= 1e-6 * abs(float(aux_loc))
