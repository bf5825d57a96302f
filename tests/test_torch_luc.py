"""The port's local update computations against the JAX package: the plain
versions of the LUC kernels (``kernels/ref.mu_update`` / ``hals_sweep``)
against the reference's Pallas kernels (interpret mode, ε = 1e-16) and
against its rule bodies (ε = ``eps_for``); the kernel wrappers' checks; the
port's ``update_mu`` / ``update_hals`` against ``repro.core.rules``; the
accelerated rules, ``partial_update_h`` and the mu/hals/amu/ahals fits, dense
and sparse, against the JAX ``NMFSolver`` — on inputs made with numpy from a
seed.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those on the card by test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rules as jrules
from repro.core.engine import NMFSolver as JaxSolver
from repro.kernels import ops as jops
from repro_torch.backends import SparseOps
from repro_torch.core import rules
from repro_torch.core.engine import NMFSolver
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# test_kernels.py's shapes (r, k) with ragged r, and k = 1 and k = 70
SHAPES = [(64, 8), (100, 10), (128, 50), (37, 1), (45, 70)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}   # scaled atol, as in test_kernels.py
BF16_RULE_TOL = 1e-2                # bf16 roundings of a few ulps after fp32 sums


def _assert_scaled(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _bf16(x):
    """x rounded to bf16 values, kept as float32 numpy (both packages then
    see the same numbers)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _luc_inputs(seed, r, k, dt="f32"):
    """X (r, k), G (k, k) a Gram, R (r, k); in bf16 X and R hold bf16
    values and G fp32, as the rules receive them."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(r, k)).astype(np.float32)
    C = rng.uniform(size=(30, k)).astype(np.float32)
    R = rng.uniform(size=(r, k)).astype(np.float32) * 5
    G = C.T @ C
    if dt == "bf16":
        X, R = _bf16(X), _bf16(R)
    return X, G, R


def _w_inputs(seed, r, k, dt="f32"):
    """Inputs of a W-step whose updates are mostly positive: X near a
    planted X* and R = X*·G plus noise (``_luc_inputs``' R clamps most
    columns to zero)."""
    rng = np.random.default_rng(seed)
    C = rng.uniform(size=(30, k)).astype(np.float32)
    G = C.T @ C
    Xs = rng.uniform(size=(r, k)).astype(np.float32)
    R = (Xs @ G + 0.1 * rng.uniform(size=(r, k))).astype(np.float32)
    X = (Xs * rng.uniform(0.5, 1.5, size=(r, k))).astype(np.float32)
    if dt == "bf16":
        X = _bf16(X)
    return X, G, R


def _t(x, dt="f32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(DTYPES[dt][0])


# -------------------------------------------------------------- kernels

@pytest.mark.parametrize("r,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["mu_update", "hals_sweep"])
def test_plain_versions_match_jax_kernels(name, r, k, dt):
    """ε = 1e-16 (the wrappers' default) against the Pallas kernels, which
    take all three operands in one dtype: G is rounded to bf16 for both."""
    X, G, R = _luc_inputs(1, r, k, dt)
    if dt == "bf16":
        G = _bf16(G)
    jdt = DTYPES[dt][1]
    want = getattr(jops, name)(jnp.asarray(X, jdt), jnp.asarray(G, jdt),
                               jnp.asarray(R, jdt))
    got = getattr(ops, name)(_t(X, dt), _t(G), _t(R, dt))
    assert got.dtype == DTYPES[dt][0]
    _assert_scaled(got.float(), want, TOL[dt])


@pytest.mark.parametrize("r,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["mu_update", "hals_sweep"])
def test_plain_versions_match_jax_rule_bodies(name, r, k, dt):
    """ε = eps_for(X.dtype) against the reference's rule bodies, with X in
    fp32 or a bf16 carry and G, R in fp32 (what the engine hands over)."""
    X, G, R = _luc_inputs(2, r, k, dt)
    Xt = _t(X, dt)
    eps = rules.eps_for(Xt.dtype)
    got = getattr(ref, name)(Xt, _t(G), _t(R), eps)
    jX = jnp.asarray(X, DTYPES[dt][1])
    if name == "mu_update":
        want = jrules.update_mu(jnp.asarray(G), jnp.asarray(R), jX)
    else:
        want = jrules.update_hals(jnp.asarray(G), jnp.asarray(R), jX,
                                  normalize=False)
    assert got.dtype == Xt.dtype
    _assert_scaled(got.float(), np.asarray(want, np.float32).astype(
        np.float32), 1e-6 if dt == "f32" else BF16_RULE_TOL)


def test_eps_is_honoured():
    """A zero row of X (X·G = 0) and a zero diagonal entry of G: the results
    follow the ε they are given (1e-16 like the Pallas kernels, eps_for like
    the rules), which differ by three orders of magnitude in the sweep."""
    X, G, R = _luc_inputs(3, 40, 6)
    X[5] = 0.0
    C = np.random.default_rng(3).uniform(size=(30, 6)).astype(np.float32)
    C[:, 2] = 0.0
    G = C.T @ C                                     # G[2, 2] = 0
    mu = ops.mu_update(_t(X), _t(G), _t(R))
    assert np.isfinite(mu.numpy()).all() and not mu[5].any()
    for eps, want in ((ref.LUC_EPS, jops.hals_sweep(jnp.asarray(X),
                                                     jnp.asarray(G),
                                                     jnp.asarray(R))),
                      (rules.eps_for(torch.float32),
                       jrules.update_hals(jnp.asarray(G), jnp.asarray(R),
                                          jnp.asarray(X)))):
        got = ops.hals_sweep(_t(X), _t(G), _t(R), eps=eps).numpy()
        assert np.isfinite(got).all() and got[:, 2].max() > 1e15
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    fixed = ops.hals_sweep(_t(X), _t(G), _t(R)).numpy()[:, 2].max()
    guard = ops.hals_sweep(_t(X), _t(G), _t(R),
                           eps=rules.eps_for(torch.float32)).numpy()[:, 2].max()
    assert guard > 100 * fixed


def test_hals_sweep_is_sequential():
    """Later columns see earlier updates (block coordinate descent), not a
    Jacobi-style simultaneous update — test_kernels.py's check."""
    X, G, R = _luc_inputs(4, 40, 6)
    seq = ops.hals_sweep(_t(X), _t(G), _t(R)).numpy()
    jacobi = np.maximum(X + (R - X @ G) / np.diag(G), 0.0)
    assert not np.allclose(seq, jacobi, atol=1e-5)
    np.testing.assert_allclose(seq, np.asarray(jops.hals_sweep(
        jnp.asarray(X), jnp.asarray(G), jnp.asarray(R))), atol=1e-5)


@pytest.mark.parametrize("case", ["g_bf16", "r_f16", "x_f16", "r_f32_x_bf16",
                                  "shape", "strided", "device_mix", "empty"])
def test_luc_wrappers_reject_what_the_kernels_do_not_take(case):
    X, G, R = (_t(a) for a in _luc_inputs(5, 16, 4))
    if case == "r_f32_x_bf16":
        # the accepted mix: a bf16 carry with fp32 R from the products
        assert ops.mu_update(X.bfloat16(), G, R).dtype == torch.bfloat16
        return
    args = {"g_bf16": (X, G.bfloat16(), R), "r_f16": (X, G, R.half()),
            "x_f16": (X.half(), G, R.half()), "shape": (X, G[:3, :3], R),
            "strided": (X, G, torch.zeros(4, 16).T),
            "device_mix": (X, G, R.to("meta")),
            "empty": (X[:0], G, R[:0])}[case]
    for fn in (ops.mu_update, ops.hals_sweep, ops.hals_sweep_norm):
        with pytest.raises((TypeError, ValueError)):
            fn(*args)


@pytest.mark.parametrize("k", [50, 1_460])
def test_w_step_takes_the_kernel_at_every_k(k):
    """On data-less tensors (the card stood in for) the one-device W-step
    records hals_sweep_norm at k = 50 and at k = 1,460, which no head-pass
    tile fits (the wide head pass takes it); float64, which no LUC kernel
    takes, is refused there and on the CPU, as by the other wrappers."""
    from repro_torch.roofline import counts
    assert ops.hals_norm_rows(1_438) == 32 and ops.hals_norm_rows(1_439) == 0
    X, R = (torch.empty(64, k, device="meta") for _ in range(2))
    G = torch.empty(k, k, device="meta")
    with counts.record_step() as rec:
        out = rules.update_hals(G, R, X, normalize=True)
    assert dict(rec.kernel_calls()) == {"hals_sweep_norm": 1}
    assert out.shape == (64, k) and out.dtype == X.dtype
    for dev in ("meta", "cpu"):
        t = [torch.zeros(4, 3, dtype=torch.float64, device=dev),
             torch.zeros(3, 3, dtype=torch.float64, device=dev),
             torch.zeros(4, 3, dtype=torch.float64, device=dev)]
        with pytest.raises(TypeError):
            rules.update_hals(t[1], t[2], t[0], normalize=True)


def test_plan_hals_sweep_norm():
    """The head pass's tile and blocks, and the column passes' blocks, at
    the benchmark's 2^24 × 50 and at Video's W at k = 160."""
    sm = ops.H100_SM_COUNT
    plan = ops.plan_hals_sweep_norm(1 << 24, 50, sm)
    assert plan.rows == 128
    assert ops.hals_norm_smem(50, 128) == (50 * 8 * 4 + 32 + 16 + 128 * 9 * 4
                                           + 8 * 128 * 4 + 128 * 51 * 4)
    assert plan.head_blocks == 6 * sm and plan.col_blocks == 4 * sm
    wide = ops.plan_hals_sweep_norm(1_013_400, 160, sm)
    assert wide.rows == 128 and wide.head_blocks == 2 * sm
    tiny = ops.plan_hals_sweep_norm(37, 1, sm)
    assert (tiny.head_blocks, tiny.col_blocks) == (1, 1)
    # past the head pass's tiles: the wide head pass, on the column
    # passes' blocks
    assert ops.plan_hals_sweep_norm(1 << 24, 1_460, sm) == (0, 4 * sm,
                                                            4 * sm)
    assert ops.plan_hals_sweep_norm(1_003, 1_460, sm) == (0, 4, 4)


# ---------------------------------------------------------------- rules

@pytest.mark.parametrize("r,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_w_sweep_matches_jax_rule_body(r, k, dt):
    """``ref.hals_sweep_norm``, the kernel's CPU mirror and the rules'
    plain loop, against the reference's normalised W-step, with X in fp32
    or a bf16 carry and G, R in fp32: fp32 at the kernels' scaled 1e-5
    (each x_i is R_i less a sum of k products that mostly cancels it)."""
    X, G, R = _w_inputs(8, r, k, dt)
    Xt = _t(X, dt)
    got = ref.hals_sweep_norm(Xt, _t(G), _t(R), rules.eps_for(Xt.dtype))
    want = jrules.update_hals(jnp.asarray(G), jnp.asarray(R),
                              jnp.asarray(X, DTYPES[dt][1]), normalize=True)
    assert got.dtype == Xt.dtype
    _assert_scaled(got.float(), np.asarray(want, np.float32),
                   TOL["f32"] if dt == "f32" else BF16_RULE_TOL)


def test_w_step_routing_on_the_cpu_and_across_ranks():
    """A CPU X takes the plain loop (no launch, the loop's bits); a
    ``norm_psum`` (a reduction over ranks) takes it everywhere, and is
    applied: two ranks holding the same rows sum twice the squares, so
    each column comes out 1/√2 of the one-device sweep's.  On data-less
    CUDA-like tensors the one-device W-step records hals_sweep_norm and the
    reduced one records no kernel."""
    from repro_torch.roofline import counts
    X, G, R = (_t(a) for a in _w_inputs(9, 40, 6))
    eps = rules.eps_for(torch.float32)
    ops.reset_launches()
    one = rules.update_hals(G, R, X, normalize=True)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert torch.equal(one, ref.hals_sweep_norm(X, G, R, eps))
    assert torch.equal(one, ops.hals_sweep_norm(X, G, R, eps=eps))
    two = rules.update_hals(G, R, X, normalize=True,
                            norm_psum=lambda v: 2.0 * v)
    assert torch.equal(two, ref.hals_sweep_norm(X, G, R, eps,
                                                lambda v: 2.0 * v))
    first = one[:, 0]
    torch.testing.assert_close(two[:, 0], first / np.sqrt(2.0), rtol=1e-6,
                               atol=0)
    Xm, Gm, Rm = (torch.empty(t.shape, device="meta") for t in (X, G, R))
    with counts.record_step() as rec:
        rules.update_hals(Gm, Rm, Xm, normalize=True)
    assert dict(rec.kernel_calls()) == {"hals_sweep_norm": 1}
    with counts.record_step() as rec:
        rules.update_hals(Gm, Rm, Xm, normalize=True, norm_psum=lambda v: v)
    assert dict(rec.kernel_calls()) == {}
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("body", ["mu", "hals_h", "hals_w"])
def test_rule_bodies_match_jax(body, dt):
    X, G, R = _luc_inputs(6, 50, 7, dt)
    Xt = _t(X, dt)
    jX = jnp.asarray(X, DTYPES[dt][1])
    if body == "mu":
        got = rules.update_mu(_t(G), _t(R), Xt)
        want = jrules.update_mu(jnp.asarray(G), jnp.asarray(R), jX)
    else:
        norm = body == "hals_w"
        got = rules.update_hals(_t(G), _t(R), Xt, normalize=norm)
        want = jrules.update_hals(jnp.asarray(G), jnp.asarray(R), jX,
                                  normalize=norm)
    assert got.dtype == Xt.dtype
    _assert_scaled(got.float(), np.asarray(want, np.float32),
                   1e-6 if dt == "f32" else BF16_RULE_TOL)


@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
def test_partial_update_h_matches_jax(algo):
    X, G, R = _luc_inputs(7, 30, 5)
    mask = np.random.default_rng(7).uniform(size=30) < 0.4
    rule, jrule = rules.get_rule(algo), jrules.get_rule(algo)
    st = rule.init_state(30, 20, 5)
    got, st = rule.partial_update_h(_t(G), _t(R), _t(X), torch.from_numpy(mask),
                                    st)
    want, jst = jrule.partial_update_h(jnp.asarray(G), jnp.asarray(R),
                                       jnp.asarray(X), jnp.asarray(mask),
                                       jrule.init_state(30, 20, 5))
    np.testing.assert_array_equal(got.numpy()[~mask], X[~mask])
    _assert_scaled(got.numpy(), want, 1e-5)
    if st is not None:
        assert st["inner_h"] == int(jst["inner_h"]) >= 1


def test_accelerated_rule_surface():
    assert {"amu", "ahals"} <= set(rules.available_algorithms())
    assert rules.get_rule("amu").inner_iters == 4
    assert rules.get_rule("ahals").normalizes_w
    assert not rules.get_rule("amu").normalizes_w
    with pytest.raises(ValueError, match="inner_iters"):
        rules.AcceleratedMURule(inner_iters=0)
    with pytest.raises(ValueError, match="delta"):
        rules.AcceleratedHALSRule(delta=-0.1)
    fixed = rules.AcceleratedMURule(inner_iters=3)
    assert fixed.prepare_global(100, 80, 8) is fixed
    with pytest.raises(RuntimeError, match="prepare_global"):
        rules.AcceleratedMURule(inner_iters=None)._budgets()
    m, n, k = 960, 640, 8
    for name in ("amu", "ahals"):
        cls = type(rules.get_rule(name))
        got = cls(inner_iters=None).prepare_global(m, n, k)
        want = type(jrules.get_rule(name))(inner_iters=None).prepare_global(
            m, n, k)
        assert (got._budget_w, got._budget_h) == (want._budget_w,
                                                  want._budget_h)


# ------------------------------------------------------------------ fits

M, N, K = 96, 64, 6


def _problem(seed=0):
    """Low rank plus noise (rel err ≳ 0.05, above the trace trick's fp32
    cancellation) and explicit factors."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
         + 0.5 * rng.uniform(size=(M, N))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    return A, W0, H0


def _sparse_problem():
    rng = np.random.default_rng(12)
    A = (rng.uniform(size=(M, N)) * (rng.uniform(size=(M, N)) < 0.3)
         ).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    return A, W0, H0


# name -> (algo, rule kwargs): the registry defaults (inner_iters=4,
# delta=0.01: data-dependent counts), the fixed loop (delta=0), the derived
# Gillis–Glineur budget (inner_iters=None), and the plain rules
RULES = {
    "mu": ("mu", None), "hals": ("hals", None),
    "amu": ("amu", {}), "ahals": ("ahals", {}),
    "amu_delta0": ("amu", {"inner_iters": 3, "delta": 0.0}),
    "ahals_delta0": ("ahals", {"inner_iters": 3, "delta": 0.0}),
    "amu_derived": ("amu", {"inner_iters": None}),
    "ahals_derived": ("ahals", {"inner_iters": None}),
}


def _rule(pkg, name):
    algo, kw = RULES[name]
    if kw is None:
        return algo
    return type(pkg.get_rule(algo))(**kw)


@functools.cache
def _jax_fit(name, sparse):
    A, W0, H0 = _sparse_problem() if sparse else _problem()
    res = JaxSolver(K, algo=_rule(jrules, name),
                    backend="sparse" if sparse else "dense",
                    max_iters=4).fit(jnp.asarray(A), W0=jnp.asarray(W0),
                                     H0=jnp.asarray(H0))
    st = res.extras["rule_state"]
    return (np.asarray(res.rel_errors), np.asarray(res.W), np.asarray(res.H),
            None if st is None else {k: int(v) for k, v in st.items()})


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", list(RULES))
def test_fit_matches_jax(name, sparse):
    A, W0, H0 = _sparse_problem() if sparse else _problem()
    backend = SparseOps() if sparse else "cuda"
    res = NMFSolver(K, algo=_rule(rules, name), backend=backend,
                    device="cpu", max_iters=4).fit(A, W0=W0, H0=H0)
    rels, W, H, st = _jax_fit(name, sparse)
    np.testing.assert_allclose(res.rel_errors.numpy(), rels, rtol=1e-4)
    _assert_scaled(res.W.numpy(), W, 1e-4)
    _assert_scaled(res.H.numpy(), H, 1e-4)
    assert res.extras["rule_state"] == st
    if name.endswith("delta0"):
        assert st == {"inner_w": 12, "inner_h": 12}


@pytest.mark.parametrize("accel,plain", [("amu", "mu"), ("ahals", "hals")])
def test_accelerated_equals_plain_at_inner_one(accel, plain):
    A, W0, H0 = _problem(1)
    cls = type(rules.get_rule(accel))
    res = NMFSolver(K, algo=cls(inner_iters=1), device="cpu",
                    max_iters=5).fit(A, W0=W0, H0=H0)
    want = NMFSolver(K, algo=plain, device="cpu", max_iters=5).fit(
        A, W0=W0, H0=H0)
    torch.testing.assert_close(res.W, want.W, rtol=0, atol=0)
    torch.testing.assert_close(res.H, want.H, rtol=0, atol=0)
    assert res.extras["rule_state"] == {"inner_w": 5, "inner_h": 5}


@pytest.mark.parametrize("algo", ["mu", "hals", "amu", "ahals"])
def test_bf16_carry_fits(algo):
    """A bf16 A and factor carry run through the LUC wrappers (bf16 X, fp32
    G and R) and come out finite, nonnegative and bf16."""
    A, W0, H0 = _problem(2)
    res = NMFSolver(K, algo=algo, device="cpu", max_iters=3).fit(
        torch.from_numpy(A).bfloat16(), W0=W0, H0=H0)
    assert res.W.dtype == res.H.dtype == torch.bfloat16
    assert torch.isfinite(res.W.float()).all() and res.W.min() >= 0
    assert np.isfinite(res.rel_errors.numpy()).all()
    assert res.rel_errors[-1] < 0.5


# ------------------------------------------------------------ wide k (F1)

def _wide_problem():
    """k = 160: the LUC kernels' wide plans on the card."""
    rng = np.random.default_rng(17)
    m, n, k = 400, 300, 160
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * k * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0, k


@pytest.mark.parametrize("algo", ["mu", "hals"])
def test_wide_k_fit_matches_jax(algo):
    """The port at k = 160 against the JAX package: the rel-error
    trajectories of 3 iterations and the factors after one agree at 1e-4,
    the factors after 3 too for MU.  HALS clamps 59 % of W to 0 by its
    third iteration here, so its factors then move with rounding: a 1-ulp
    change of A moves the port's own W by 1.6e-3 after three iterations."""
    A, W0, H0, k = _wide_problem()
    for iters in (1, 3):
        res = NMFSolver(k, algo=algo, device="cpu", max_iters=iters).fit(
            A, W0=W0, H0=H0)
        want = JaxSolver(k, algo=algo, backend="dense", max_iters=iters).fit(
            jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0))
        np.testing.assert_allclose(res.rel_errors.numpy(),
                                   np.asarray(want.rel_errors), rtol=1e-4)
        if iters == 1 or algo == "mu":
            _assert_scaled(res.W.numpy(), np.asarray(want.W), 1e-4)
            _assert_scaled(res.H.numpy(), np.asarray(want.H), 1e-4)
