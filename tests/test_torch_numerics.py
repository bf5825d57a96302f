"""The port's serial numerics (repro_torch.core: bpp, rules, error) against
the JAX package's, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bpp as jbpp
from repro.core import error as jerror
from repro.core import rules as jrules
from repro_torch.core import bpp, error, rules

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def _gram_problem(seed, r, k, *, scale=10.0):
    """A well-conditioned Gram G = CᵀC and a right-hand side with mixed
    signs, so BPP has active constraints to pivot on."""
    rng = _rng(seed)
    C = rng.normal(size=(4 * k + 20, k)).astype(np.float32)
    R = (scale * rng.normal(size=(r, k))).astype(np.float32)
    return C.T @ C, R


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_scaled(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ------------------------------------------------------------------- bpp

@pytest.mark.parametrize("seed,r,k", [(0, 64, 8), (1, 200, 12), (2, 5, 3),
                                      (3, 96, 6), (4, 40, 16)])
def test_solve_bpp_matches_jax(seed, r, k):
    G, R = _gram_problem(seed, r, k)
    got = bpp.solve_bpp(_t(G), _t(R)).numpy()
    want = np.asarray(jbpp.solve_bpp(jnp.asarray(G), jnp.asarray(R)))
    assert (got >= 0).all()
    _assert_scaled(got, want, 1e-4)


def test_solve_bpp_kkt():
    G, R = _gram_problem(5, 128, 10)
    X = bpp.solve_bpp(_t(G), _t(R)).numpy()
    Y = X @ G.T - R
    assert X.min() >= 0
    assert Y.min() >= -1e-3 * np.abs(R).max()
    assert np.abs(X * Y).max() < 1e-4 * (np.abs(R).max() + 1)


def test_solve_bpp_interior_solution_is_the_linear_solve():
    rng = _rng(6)
    k = 6
    Q = rng.normal(size=(40, k)).astype(np.float32)
    G = Q.T @ Q + np.eye(k, dtype=np.float32)
    x_true = (rng.uniform(size=(5, k)) + 0.5).astype(np.float32)
    X = bpp.solve_bpp(_t(G), _t(x_true @ G.T)).numpy()
    np.testing.assert_allclose(X, x_true, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["zero", "rank_one"])
def test_singular_gram_gives_nan_like_the_reference(kind):
    """A singular passive system gives non-finite rows — no exception —
    exactly where the reference's jnp.linalg.solve gives them."""
    rng = _rng(7)
    k = 5
    if kind == "zero":
        G = np.zeros((k, k), np.float32)
    else:
        c = np.repeat(rng.normal(size=(20, 1)), k, axis=1).astype(np.float32)
        G = c.T @ c
    R = rng.uniform(size=(6, k)).astype(np.float32)
    got = bpp.solve_bpp(_t(G), _t(R)).numpy()
    want = np.asarray(jbpp.solve_bpp(jnp.asarray(G), jnp.asarray(R)))
    assert np.isnan(got).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_solve_bpp_chunked_is_bit_identical(chunk, monkeypatch):
    G, R = _gram_problem(8, 100, 9)
    whole = bpp.solve_bpp(_t(G), _t(R))
    monkeypatch.setattr(bpp, "_CHUNK_ELEMS", chunk * 9 * 9)   # chunk rows
    assert torch.equal(bpp.solve_bpp(_t(G), _t(R)), whole)


def test_solve_bpp_max_iter_caps_like_the_reference():
    G, R = _gram_problem(9, 50, 10)
    for cap in (1, 2):
        got = bpp.solve_bpp(_t(G), _t(R), max_iter=cap).numpy()
        want = np.asarray(jbpp.solve_bpp(jnp.asarray(G), jnp.asarray(R),
                                         max_iter=cap))
        _assert_scaled(got, want, 1e-4)


# ----------------------------------------------------------------- rules

@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_eps_for_matches_jax(dt):
    assert rules.eps_for(getattr(torch, dt)) == jrules.eps_for(
        getattr(jnp, dt))


def _luc_problem(seed, r=50, k=7):
    rng = _rng(seed)
    C = rng.uniform(size=(30, k)).astype(np.float32)
    X = rng.uniform(0.1, 1.0, size=(r, k)).astype(np.float32)
    R = rng.uniform(size=(r, k)).astype(np.float32) * 5
    return C.T @ C, R, X


def test_update_mu_matches_jax():
    G, R, X = _luc_problem(10)
    got = rules.update_mu(_t(G), _t(R), _t(X)).numpy()
    want = jrules.update_mu(jnp.asarray(G), jnp.asarray(R), jnp.asarray(X))
    _assert_scaled(got, want, 1e-6)


@pytest.mark.parametrize("normalize", [False, True])
def test_update_hals_matches_jax(normalize):
    G, R, X = _luc_problem(11)
    Xt = _t(X)
    got = rules.update_hals(_t(G), _t(R), Xt, normalize=normalize).numpy()
    want = jrules.update_hals(jnp.asarray(G), jnp.asarray(R), jnp.asarray(X),
                              normalize=normalize)
    _assert_scaled(got, want, 1e-5)
    np.testing.assert_array_equal(Xt.numpy(), X)      # input untouched


def test_update_hals_norm_psum_hook_sees_each_column():
    G, R, X = _luc_problem(12, k=5)
    seen = []

    def psum(v):
        seen.append(float(v))
        return v

    rules.update_hals(_t(G), _t(R), _t(X), normalize=True, norm_psum=psum)
    assert len(seen) == 5 and all(v >= 0 for v in seen)


@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
@pytest.mark.parametrize("reg", [{}, {"l1": 0.3}, {"l2": 0.5},
                                 {"l1": 0.1, "l2": 0.2}])
def test_rule_half_updates_match_jax(algo, reg):
    G, R, X = _luc_problem(13)
    rt = rules.get_rule(algo).__class__(**reg)
    rj = jrules.get_rule(algo).__class__(**reg)
    for half in ("update_w", "update_h"):
        got, st = getattr(rt, half)(_t(G), _t(R), _t(X))
        want, _ = getattr(rj, half)(jnp.asarray(G), jnp.asarray(R),
                                    jnp.asarray(X))
        assert st is None
        _assert_scaled(got.numpy(), want, 1e-4)


def test_registry_matches_the_reference_names():
    for name in ("mu", "hals", "bpp", "abpp", "anls", "MU"):
        assert rules.get_rule(name).name == jrules.get_rule(name).name
    assert rules.get_rule("mu").positive_init
    assert not rules.get_rule("bpp").positive_init
    with pytest.raises(ValueError):
        rules.get_rule("nope")
    with pytest.raises(ValueError):
        rules.register_algorithm("mu", rules.MURule)
    with pytest.raises(ValueError):
        rules.MURule(l1=-1.0)
    with pytest.raises(TypeError):
        rules.get_rule(3)


# ----------------------------------------------------------------- error

def test_sq_error_from_products_matches_jax():
    rng = _rng(14)
    m, n, k = 40, 30, 5
    A = rng.uniform(size=(m, n)).astype(np.float32)
    W = rng.uniform(size=(m, k)).astype(np.float32)
    H = rng.uniform(size=(k, n)).astype(np.float32)
    WtA, WtW, HHt = W.T @ A, W.T @ W, H @ H.T
    nsq = np.float32((A.astype(np.float64) ** 2).sum())
    want = float(jerror.sq_error_from_products(
        jnp.asarray(nsq), jnp.asarray(WtA), jnp.asarray(H), jnp.asarray(WtW),
        jnp.asarray(HHt)))
    got = float(error.sq_error_from_products(
        torch.tensor(nsq), _t(WtA), _t(H), _t(WtW), _t(HHt)))
    # the port passes the transposed pair (AᵀW, Hᵀ): the same sum
    got_t = float(error.sq_error_from_products(
        torch.tensor(nsq), _t(WtA.T), _t(H.T), _t(WtW), _t(HHt)))
    np.testing.assert_allclose([got, got_t], [want, want], rtol=1e-5)
    direct = float(((A - W @ H).astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(got, direct, rtol=1e-4)
    rel = float(error.relative_error(_t(A), _t(W), _t(H)))
    np.testing.assert_allclose(rel, float(jerror.relative_error(
        jnp.asarray(A), jnp.asarray(W), jnp.asarray(H))), rtol=1e-5)


def test_sq_frobenius_chunked(monkeypatch):
    rng = _rng(15)
    A = rng.uniform(size=(37, 11)).astype(np.float32)
    want = float(jerror.sq_frobenius(jnp.asarray(A)))
    monkeypatch.setattr(error, "_CHUNK_ELEMS", 30)      # 2 rows per chunk
    got = error.sq_frobenius(_t(A))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    got_bf16 = float(error.sq_frobenius(_t(A).to(torch.bfloat16)))
    np.testing.assert_allclose(got_bf16, want, rtol=2e-2)
