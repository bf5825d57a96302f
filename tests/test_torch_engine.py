"""The port's serial engine, NMFSolver(backend="cuda", device="cpu"), against
the JAX package's NMFSolver with its Pallas kernels (interpret mode) and its
dense backend: same numpy A and the same explicit W0/H0 on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import NMFSolver as JaxSolver
from repro_torch.core.engine import NMFSolver, StoppingCriterion
from repro_torch.backends import infer_backend
from repro_torch.data import pipeline
from repro_torch.data.pipeline import lowrank_matrix
from repro_torch.util import device as device_util
from repro_torch.util.convert import factors_from_numpy, result_to_numpy

torch.set_num_threads(1)

M, N, K = 96, 64, 6
ALGOS = ["mu", "hals", "bpp"]


def _problem(seed=0, m=M, n=N, k=K, noise=0.5):
    """Low rank plus noise, so the Grams are well conditioned."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + noise * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0


def _jax_fit(A, k, algo, backend, **kw):
    init = kw.pop("init", None)
    W0, H0 = kw.pop("W0", None), kw.pop("H0", None)
    solver = JaxSolver(k, algo=algo, backend=backend, **kw)
    if init is not None:
        return solver.fit(jnp.asarray(A), init=init)
    return solver.fit(jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0))


def _port(k, algo, **kw):
    return NMFSolver(k, algo=algo, backend="cuda", device="cpu", **kw)


def _assert_scaled(got, want, atol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _assert_same_run(res, jres):
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               np.asarray(jres.rel_errors), rtol=1e-4)
    _assert_scaled(res.W.numpy(), jres.W)
    _assert_scaled(res.H.numpy(), jres.H)
    assert res.iters == jres.iters


@pytest.mark.parametrize("jax_backend", ["pallas", "dense"])
@pytest.mark.parametrize("algo", ALGOS)
def test_serial_fit_matches_jax(algo, jax_backend):
    A, W0, H0 = _problem()
    res = _port(K, algo, max_iters=3).fit(A, W0=W0, H0=H0)
    jres = _jax_fit(A, K, algo, jax_backend, max_iters=3, W0=W0, H0=H0)
    _assert_same_run(res, jres)
    assert res.W.shape == (M, K) and res.H.shape == (K, N)
    assert res.W.is_contiguous() and res.H.is_contiguous()
    assert res.extras["backend"] == "cuda" and res.extras["device"] == "cpu"


@pytest.mark.parametrize("algo", ALGOS)
def test_warm_start_from_jax_factors(algo):
    """JAX trains 3 iterations; both packages resume from those factors for
    2 more and must agree."""
    A, W0, H0 = _problem(1)
    first = _jax_fit(A, K, algo, "dense", max_iters=3, W0=W0, H0=H0)
    W, H = factors_from_numpy(np.asarray(first.W), np.asarray(first.H),
                              device="cpu")
    res = _port(K, algo, max_iters=2).fit(A, init=(W, H))
    jres = _jax_fit(A, K, algo, "dense", max_iters=2, init=first)
    _assert_same_run(res, jres)
    # and back: the port's factors warm-start the JAX package
    back = _jax_fit(A, K, algo, "dense", max_iters=1,
                    init=result_to_numpy(res))
    again = _port(K, algo, max_iters=1).fit(A, init=res)
    _assert_same_run(again, back)


def test_tolerance_stops_like_jax():
    A, W0, H0 = _problem(2)
    ref = _jax_fit(A, K, "bpp", "dense", max_iters=8, W0=W0, H0=H0)
    rels = np.asarray(ref.rel_errors)
    tol = float(rels[4]) * (1 + 1e-3)          # reached at iteration 5
    assert rels[3] > tol * (1 + 1e-3)
    res = _port(K, "bpp", max_iters=50, tol=tol).fit(A, W0=W0, H0=H0)
    jres = _jax_fit(A, K, "bpp", "pallas", max_iters=50, tol=tol, W0=W0,
                    H0=H0)
    assert res.extras["stopped_early"] and res.iters == 5
    _assert_same_run(res, jres)
    assert res.rel_errors.shape == (res.iters,)


def test_stall_stops_like_jax():
    A, W0, H0 = _problem(3)
    kw = dict(max_iters=40, stall_iters=2, stall_tol=2e-3)
    res = _port(K, "mu", **kw).fit(A, W0=W0, H0=H0)
    jres = _jax_fit(A, K, "mu", "dense", W0=W0, H0=H0, **kw)
    assert res.extras["stopped_early"] and res.iters < 40
    _assert_same_run(res, jres)


def test_fixed_run_matches_adaptive_prefix():
    A, W0, H0 = _problem(4)
    fixed = _port(K, "hals", max_iters=6).fit(A, W0=W0, H0=H0)
    adaptive = _port(K, "hals", max_iters=6, tol=1e-12).fit(A, W0=W0, H0=H0)
    assert adaptive.iters == 6 and not adaptive.extras["stopped_early"]
    np.testing.assert_allclose(fixed.rel_errors.numpy(),
                               adaptive.rel_errors.numpy(), rtol=1e-6)


def test_segments_compose_to_one_run():
    A, W0, H0 = _problem(5)
    solver = _port(K, "bpp", max_iters=5)
    whole = solver.fit(A, W0=W0, H0=H0)
    rs = solver.prepare_state(A, W0=W0, H0=H0)
    solver.run_segment(rs, 2)
    solver.run_segment(rs, 3)
    seg = solver.collect_result(rs)
    assert torch.equal(seg.W, whole.W) and torch.equal(seg.H, whole.H)
    assert torch.equal(seg.rel_errors, whole.rel_errors)


def test_random_init_is_seeded():
    A, _, _ = _problem(6)
    a = _port(K, "mu", max_iters=2).fit(A, seed=3)
    b = _port(K, "mu", max_iters=2).fit(A, seed=3)
    c = _port(K, "mu", max_iters=2).fit(A, seed=4)
    assert torch.equal(a.W, b.W) and not torch.equal(a.W, c.W)
    assert np.all(np.diff(a.rel_errors.numpy()) <= 1e-6)


def test_float64_numpy_input_runs_in_float32():
    A, W0, H0 = _problem(10)
    res = _port(K, "mu", max_iters=2).fit(A.astype(np.float64), W0=W0, H0=H0)
    ref = _port(K, "mu", max_iters=2).fit(A, W0=W0, H0=H0)
    assert res.W.dtype == torch.float32
    assert torch.equal(res.W, ref.W)


def test_kernel_backend_equals_dense_backend_on_cpu():
    A, W0, H0 = _problem(7)
    k = NMFSolver(K, algo="mu", backend="cuda", device="cpu",
                  max_iters=3).fit(A, W0=W0, H0=H0)
    d = NMFSolver(K, algo="mu", backend="dense", device="cpu",
                  max_iters=3).fit(A, W0=W0, H0=H0)
    assert torch.equal(k.W, d.W) and torch.equal(k.H, d.H)


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NMFSolver(K)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_util.resolve_device("cuda")
    assert device_util.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("schedule", ["faun", "naive", "gspmd"])
def test_unported_schedules_raise(schedule):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NMFSolver(K, schedule=schedule, device="cpu")


def test_bad_arguments_raise():
    A, W0, H0 = _problem(8)
    with pytest.raises(ValueError):
        NMFSolver(K, schedule="mpi", device="cpu")
    with pytest.raises(ValueError):
        _port(K, "mu").fit(A, init=(W0, H0), W0=W0)
    with pytest.raises(ValueError):
        _port(K, "mu").fit(A, init=(W0[:, :3], H0))
    with pytest.raises(TypeError):
        _port(K, "mu").fit(A, init="nope")
    assert StoppingCriterion(stall_iters=2).adaptive
    assert not StoppingCriterion().adaptive


@pytest.mark.parametrize("chunk_elems", [None, 5 * 23])
def test_lowrank_matrix(chunk_elems, monkeypatch):
    def make(seed, **kw):
        gen = device_util.make_generator(torch.device("cpu"), seed)
        return lowrank_matrix(gen, 37, 23, 4, **kw)

    whole = make(12)                     # one chunk
    if chunk_elems:
        monkeypatch.setattr(pipeline, "_CHUNK_ELEMS", chunk_elems)
    A = make(11, noise=0.5)
    assert A.shape == (37, 23) and A.dtype == torch.float32
    assert float(A.min()) >= 0 and float(A.max()) <= 4 + 0.5
    assert torch.equal(A, make(11, noise=0.5))
    exact = make(12)
    np.testing.assert_allclose(exact.numpy(), whole.numpy(), rtol=1e-6)
    assert torch.linalg.matrix_rank(exact).item() == 4


def test_infer_backend():
    assert infer_backend(np.zeros((2, 2))) == "dense"
    assert infer_backend(torch.zeros(2, 2)) == "dense"
    assert infer_backend(torch.zeros(2, 2).to_sparse()) == "sparse"

