"""The port's ``MicroBatcher`` (``repro_torch.serve.batcher``): the nine
batcher cases of tests/test_serve.py against the port's projector —
coalescing with per-request results, concurrent submitters, hot swap with
no lost request, an in-flight batch finishing on the old projector, swap
validation, exceptions delivered with the worker recovering, swap racing
close, a row-count mismatch, a cancelled future — and the coalesced
results against the JAX package's projector on the same rows.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.artifact import FactorArtifact as JaxArtifact
from repro.serve.foldin import FoldInProjector as JaxProjector
from repro_torch.core.engine import NMFSolver
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.foldin import FoldInProjector

M, N, K = 96, 64, 6


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
            ).astype(np.float32)


A = _problem()


@pytest.fixture(scope="module")
def art():
    res = NMFSolver(K, algo="bpp", max_iters=40, device="cpu").fit(A)
    return FactorArtifact.from_result(res)


def _proj(art, **kw):
    return FoldInProjector(art, device="cpu", **kw)


def test_batcher_coalesces_and_returns_per_request(art):
    proj = _proj(art, max_batch=32)
    proj.warmup()
    rows = A[:24]
    direct = proj.project(rows).numpy()
    with MicroBatcher(proj.project, max_batch=32, max_delay_s=0.25) as mb:
        futs = [mb.submit(rows[i]) for i in range(24)]
        got = np.stack([f.result(timeout=30).numpy() for f in futs])
    np.testing.assert_allclose(got, direct, atol=1e-4)
    stats = mb.stats
    assert stats.requests == 24
    assert stats.max_batch_seen >= 2, "no coalescing happened"
    assert stats.max_batch_seen <= 32
    # the same rows through the JAX package's projector on the same factors
    jart = JaxArtifact.from_factors(jnp.asarray(art.W.numpy()),
                                    jnp.asarray(art.H.numpy()), algo="bpp")
    want = np.asarray(JaxProjector(jart, max_batch=32).project(
        jnp.asarray(rows)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_batcher_concurrent_submitters(art):
    proj = _proj(art, max_batch=16)
    proj.warmup()
    direct = _proj(art, max_batch=M).project(A).numpy()
    results = {}
    with MicroBatcher(proj.project, max_batch=16, max_delay_s=0.05) as mb:
        def client(lo, hi):
            futs = [(i, mb.submit(torch.from_numpy(A[i])))
                    for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(timeout=30)
        threads = [threading.Thread(target=client, args=(lo, lo + 24))
                   for lo in (0, 24, 48)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert sorted(results) == list(range(72))
    np.testing.assert_allclose(
        np.stack([results[i].numpy() for i in range(72)]), direct[:72],
        atol=1e-4)
    assert mb.stats.requests == 72


def test_batcher_swap_hot_reload_no_lost_requests():
    tag_a = lambda batch: np.asarray(batch) + 1000.0
    tag_b = lambda batch: np.asarray(batch) + 2000.0
    rows = np.arange(120, dtype=np.float32).reshape(120, 1)
    with MicroBatcher(tag_a, max_batch=8, max_delay_s=1e-3) as mb:
        futs = []
        for i in range(120):
            futs.append((i, mb.submit(rows[i])))
            if i == 60:
                mb.swap(tag_b)
        got = {i: float(f.result(timeout=30)[0]) for i, f in futs}
    assert len(got) == 120
    assert mb.stats.requests == 120
    for i, v in got.items():
        assert v in (i + 1000.0, i + 2000.0), (i, v)
    late = [got[i] for i in range(110, 120)]
    assert all(v >= 2000.0 for v in late), late


def test_batcher_swap_in_flight_batch_completes_against_old(art):
    released = threading.Event()
    first_done = threading.Event()

    def slow_old(batch):
        first_done.set()
        released.wait(timeout=30)
        return np.asarray(batch) + 1000.0

    proj_new = _proj(art, max_batch=8)
    with MicroBatcher(slow_old, max_batch=1, max_delay_s=1e-4) as mb:
        f_old = mb.submit(np.zeros(3, np.float32))
        assert first_done.wait(timeout=10)
        mb.swap(proj_new)                   # a FoldInProjector is accepted
        f_new = mb.submit(A[0])
        released.set()
        old = f_old.result(timeout=30)
        new = f_new.result(timeout=30)
    np.testing.assert_allclose(old, 1000.0 * np.ones(3))
    assert tuple(new.shape) == (K,)
    np.testing.assert_allclose(new.numpy(),
                               proj_new.project(A[:1]).numpy()[0], atol=1e-5)


def test_batcher_swap_validation():
    mb = MicroBatcher(lambda b: np.asarray(b), max_batch=2)
    with pytest.raises(TypeError, match="callable"):
        mb.swap(object())
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.swap(lambda b: b)
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(lambda b: b, max_batch=0)


def test_batcher_delivers_exceptions_and_recovers():
    calls = []

    def flaky(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return torch.as_tensor(np.asarray(batch)) * 2.0

    with MicroBatcher(flaky, max_batch=4, max_delay_s=0.02) as mb:
        bad = mb.submit(np.ones(3))
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=10)
        ok = mb.submit(np.ones(3))
        np.testing.assert_allclose(ok.result(timeout=10).numpy(),
                                   2 * np.ones(3))
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.ones(3))


def test_batcher_swap_racing_close_drains_against_new_projector():
    started, released = threading.Event(), threading.Event()

    def slow_old(batch):
        started.set()
        assert released.wait(timeout=30)
        return torch.full((len(batch), 3), 1.0)

    def new(batch):
        return torch.full((len(batch), 3), 2.0)

    mb = MicroBatcher(slow_old, max_batch=1, max_delay_s=1e-4)
    f_inflight = mb.submit(torch.zeros(3))
    assert started.wait(timeout=10)
    f_queued = mb.submit(torch.zeros(3))
    closer = threading.Thread(target=mb.close)
    closer.start()
    for _ in range(1000):
        if mb._closed:
            break
        threading.Event().wait(0.005)
    assert mb._closed
    mb.swap(new)                             # accepted mid-drain
    released.set()
    np.testing.assert_allclose(f_inflight.result(timeout=30).numpy(),
                               np.ones(3))
    np.testing.assert_allclose(f_queued.result(timeout=30).numpy(),
                               2 * np.ones(3))
    closer.join(timeout=30)
    assert not mb._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        mb.swap(new)


def test_batcher_row_count_mismatch_delivers_exception():
    calls = []

    def broken(batch):
        calls.append(len(batch))
        if len(calls) == 1:
            return torch.zeros((len(batch) + 2, 3))
        return torch.as_tensor(np.asarray(batch))

    with MicroBatcher(broken, max_batch=2, max_delay_s=1e-3) as mb:
        bad = mb.submit(np.ones(3, np.float32))
        with pytest.raises(RuntimeError, match="rows"):
            bad.result(timeout=10)
        ok = mb.submit(np.ones(3, np.float32))
        np.testing.assert_allclose(ok.result(timeout=10).numpy(),
                                   np.ones(3))


def test_batcher_cancelled_future_does_not_break_batch_delivery():
    started, released = threading.Event(), threading.Event()

    def gate(batch):
        if not started.is_set():
            started.set()
            assert released.wait(timeout=30)
        return np.asarray(batch) * 2.0

    with MicroBatcher(gate, max_batch=2, max_delay_s=0.05) as mb:
        mb.submit(np.ones(3, np.float32))
        assert started.wait(timeout=10)
        f1 = mb.submit(np.ones(3, np.float32))
        f2 = mb.submit(np.ones(3, np.float32))
        assert f2.cancel()
        released.set()
        np.testing.assert_allclose(f1.result(timeout=30), 2 * np.ones(3))
        assert f2.cancelled()


def test_batcher_stacks_tensor_rows_as_a_tensor(art):
    """Tensor rows stack with ``torch.stack``, list payloads deliver per
    item, and the spans of a batch land in an enabled default tracer."""
    from repro_torch.obs.trace import default_tracer
    seen = []

    def record(batch):
        seen.append(type(batch))
        return [("code", i) for i in range(len(batch))]

    tr = default_tracer().enable()
    try:
        with MicroBatcher(record, max_batch=4, max_delay_s=0.05) as mb:
            futs = [mb.submit(torch.ones(2)) for _ in range(3)]
            got = [f.result(timeout=10) for f in futs]
    finally:
        tr.disable()
    assert seen and all(t is torch.Tensor for t in seen)
    assert len(got) == 3 and all(tag == "code" for tag, _ in got)
    names = {e.name for e in tr.spans()}
    assert {"batcher.enqueue", "batcher.coalesce", "batcher.project",
            "batcher.deliver"} <= names
    tr.clear()
