"""The port's streaming loop (``repro_torch.online``) — the cases of
tests/test_online.py on the CPU path — and against the JAX package's
``OnlineNMF``: the drift energies, the block partition, and a scripted
stream on which both take the same action at every batch, publish the
same versions and hold the same factors (a scaled 1e-4).

The scripted stream is built so that no decision sits near a threshold:
every batch's drift, per block and in total, is asserted to lie at least
a quarter of a threshold away from it, in both packages, so a change in
rounding cannot flip a decision unnoticed (the test fails on the margin,
loudly, rather than flaking on the action).
"""

import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.core import rules as _rules
from repro_torch.core.engine import NMFSolver
from repro_torch.data.pipeline import stream_batch
from repro_torch.online import (DriftAccumulator, OnlineNMF,
                                block_residual_energy, block_slices)
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.foldin import FoldInProjector
from repro_torch.serve.mesh import serve_mesh

torch.set_num_threads(1)

N, K = 64, 6
ALGOS = ("mu", "hals", "bpp")
CPU = dict(device="cpu")


def _rng(session_seed, salt=0):
    return np.random.RandomState(session_seed % (2 ** 31) + salt)


def _batch(seed, step, rows, **kw):
    return stream_batch(seed, step, rows=rows, n=N, k=K, device="cpu", **kw)


def _svc(A0, **kw):
    kw.setdefault("k", K)
    kw.setdefault("algo", "bpp")
    kw.setdefault("max_delay_s", 1e-4)
    if "solver" not in kw:
        kw.setdefault("device", "cpu")
    return OnlineNMF(A0, **kw)


@pytest.fixture(scope="module")
def A0(session_seed):
    return _batch(session_seed, 0, 48, noise=0.01)


@pytest.fixture(scope="module")
def trained(A0, session_seed):
    return NMFSolver(K, algo="bpp", max_iters=200, tol=1e-5, **CPU).fit(
        A0, seed=session_seed)


# ------------------------------------------------- partial_update_h hook --

@pytest.mark.parametrize("algo", ALGOS)
def test_partial_update_h_full_mask_is_update_h(algo, session_seed):
    rng = _rng(session_seed, 1)
    m, n = 40, 32
    rule = _rules.get_rule(algo).prepare_global(m, n, K)
    W = torch.from_numpy(rng.rand(m, K).astype(np.float32))
    A = torch.from_numpy(rng.rand(m, n).astype(np.float32))
    G, R = W.T @ W, A.T @ W
    X = torch.from_numpy(rng.rand(n, K).astype(np.float32))
    st0 = rule.init_state(m, n, K)
    full, _ = rule.update_h(G, R, X, st0)
    part, _ = rule.partial_update_h(G, R, X, None, st0)
    assert torch.equal(part, full)
    ones, _ = rule.partial_update_h(G, R, X, torch.ones(n, dtype=bool), st0)
    assert torch.equal(ones, full)


@pytest.mark.parametrize("algo", ALGOS)
def test_partial_update_h_mask_freezes_rows(algo, session_seed):
    rng = _rng(session_seed, 2)
    m, n = 40, 32
    rule = _rules.get_rule(algo).prepare_global(m, n, K)
    W = torch.from_numpy(rng.rand(m, K).astype(np.float32))
    A = torch.from_numpy(rng.rand(m, n).astype(np.float32))
    G, R = W.T @ W, A.T @ W
    X = torch.from_numpy(rng.rand(n, K).astype(np.float32))
    mask = torch.from_numpy(np.arange(n) % 2 == 0)
    st0 = rule.init_state(m, n, K)
    out, _ = rule.partial_update_h(G, R, X, mask, st0)
    full, _ = rule.update_h(G, R, X, st0)
    assert torch.equal(out[::2], full[::2])
    assert torch.equal(out[1::2], X[1::2])


# ------------------------------------------------------ fit(init=...) -----

def test_fit_init_tuple_resumes(A0, session_seed):
    solver = NMFSolver(K, algo="hals", max_iters=15, **CPU)
    first = solver.fit(A0, seed=session_seed)
    resumed = solver.fit(A0, init=(first.W, first.H))
    assert resumed.rel_errors[0] <= first.rel_errors[-1] * 1.01
    assert resumed.rel_errors[-1] <= resumed.rel_errors[0] * 1.001
    cold = solver.fit(A0, seed=session_seed)
    assert resumed.rel_errors[-1] <= cold.rel_errors[-1] * 1.01


def test_fit_init_accepts_result_and_artifact(A0, trained):
    solver = NMFSolver(K, algo="bpp", max_iters=3, **CPU)
    from_res = solver.fit(A0, init=trained)
    from_art = solver.fit(A0, init=FactorArtifact.from_result(trained))
    torch.testing.assert_close(from_res.W, from_art.W, atol=1e-5, rtol=0)
    cold = solver.fit(A0, seed=7)
    assert from_res.rel_errors[-1] <= trained.rel_errors[-1] + 1e-4
    assert from_res.rel_errors[-1] < cold.rel_errors[-1] * 0.5


# -------------------------------------------------- warm-start fold-in ----

def test_ingest_codes_equal_cold_foldin(A0, trained, session_seed):
    rows = _batch(session_seed, 1, 16, noise=0.01)
    with _svc(A0, result=trained, block_threshold=np.inf,
              full_threshold=np.inf) as svc:
        art_before = svc.artifact
        rep = svc.ingest(rows)
        got = svc.W[-16:]
        assert svc.shape == (64, N)
    assert rep.action == "extend"
    cold = FoldInProjector(art_before, **CPU).project(rows)
    torch.testing.assert_close(got, cold, atol=1e-6, rtol=0)


def test_sparse_ingest_matches_dense(A0, trained, session_seed):
    rng = _rng(session_seed, 3)
    dense = (rng.rand(8, N) * (rng.rand(8, N) < 0.2)).astype(np.float32)
    mk = lambda: _svc(A0, result=trained, block_threshold=np.inf,
                      full_threshold=np.inf)
    with mk() as a, mk() as b:
        a.ingest(dense)
        b.ingest(torch.from_numpy(dense).to_sparse())
        torch.testing.assert_close(a.W, b.W, atol=1e-6, rtol=0)
        assert torch.equal(a.H, b.H) and a.shape == b.shape
        assert torch.equal(a.A, b.A)


def test_ingest_validates_width(A0, trained):
    with _svc(A0, result=trained) as svc:
        with pytest.raises(ValueError, match="features"):
            svc.ingest(np.ones((2, N + 1), np.float32))


def test_ingest_never_copies_the_store(A0, trained, session_seed):
    """The store starts with a quarter of its rows as headroom (48 + 12):
    ingests write after the prefix; the buffer grows only when full."""
    with _svc(A0, result=trained, block_threshold=np.inf,
              full_threshold=np.inf) as svc:
        buf = svc.A.data_ptr()
        first = svc.artifact.W
        svc.ingest(_batch(session_seed, 1, 8))
        assert svc.A.data_ptr() == buf and svc.shape == (56, N)
        assert torch.equal(svc.A[:48], A0)
        # a published artifact keeps its rows: later ingests append only
        assert first.shape == (48, K) and torch.equal(first, trained.W)
        svc.ingest(_batch(session_seed, 2, 8))      # past the headroom
        assert svc.A.data_ptr() != buf and svc.shape == (64, N)
        assert torch.equal(svc.A[:48], A0)
        assert torch.equal(first, trained.W)


# ------------------------------------------------- touched-block refresh --

@pytest.mark.parametrize("algo", ALGOS)
def test_partial_refresh_equals_restricted_full_sweep(A0, trained,
                                                      session_seed, algo):
    """Row-separability: refreshing only the touched columns (gathered)
    equals a FULL H sweep restricted to those columns, and the untouched
    columns keep their bits."""
    rows = _batch(session_seed, 2, 16, drift=0.6)
    with _svc(A0, result=trained, algo=algo, n_blocks=8,
              block_threshold=1e-6, full_threshold=np.inf) as svc:
        H_before = svc.H
        rep = svc.ingest(rows)
        H_after, W_after = svc.H, svc.W
    assert rep.action == "refresh" and rep.touched_blocks
    rule = _rules.get_rule(algo).prepare_global(W_after.shape[0], N, K)
    A_acc = torch.cat([A0, rows])
    full, _ = rule.update_h(W_after.T @ W_after, A_acc.T @ W_after,
                            H_before.T.contiguous(),
                            rule.init_state(W_after.shape[0], N, K))
    full = full.T
    mask = torch.zeros(N, dtype=bool)
    for b in rep.touched_blocks:
        mask[block_slices(N, 8)[b]] = True
    torch.testing.assert_close(H_after[:, mask], full[:, mask], atol=2e-5,
                               rtol=0)
    assert torch.equal(H_after[:, ~mask], H_before[:, ~mask])

    def relerr(H):
        return float(torch.linalg.norm(A_acc - W_after @ H)
                     / torch.linalg.norm(A_acc))
    assert relerr(H_after) <= relerr(H_before) + 1e-6


def test_refactor_reaches_scratch_quality(A0, session_seed):
    with _svc(A0, seed=session_seed, block_threshold=np.inf,
              full_threshold=0.1) as svc:
        batches = []
        for step in range(1, 7):
            batches.append(_batch(session_seed, step, 16, drift=0.3,
                                  noise=0.01))
            if svc.ingest(batches[-1]).action == "refactor":
                break
        assert svc.stats.full_refactors >= 1
        A_acc = torch.cat([A0] + batches)
        scratch = NMFSolver(K, algo="bpp", max_iters=60, tol=1e-5,
                            **CPU).fit(A_acc, seed=session_seed)
        assert svc.rel_err() <= float(scratch.rel_errors[-1]) * 1.5 + 0.02


# ----------------------------------------------------------- lineage ------

def test_lineage_monotone_and_reported(A0, trained, session_seed):
    with _svc(A0, result=trained, block_threshold=np.inf,
              full_threshold=np.inf) as svc:
        assert svc.version == 0 and svc.artifact.parent_version is None
        for step in range(1, 4):
            rep = svc.ingest(_batch(session_seed, step, 8))
            assert rep.version == step == svc.version
            assert svc.artifact.version == step
            assert svc.artifact.parent_version == step - 1
            assert svc.artifact.rows_absorbed == 8
        assert svc.stats.publishes == 3


# ------------------------------------------------------- drift units ------

def test_drift_zero_when_explained(session_seed):
    rng = _rng(session_seed, 4)
    X = torch.from_numpy(rng.rand(10, K).astype(np.float32))
    H = torch.from_numpy(rng.rand(K, N).astype(np.float32))
    acc = DriftAccumulator(N, n_blocks=8)
    excess = acc.observe(X @ H, X, H)
    assert float(np.max(excess)) < 1e-8
    assert not acc.touched().any() and not acc.should_refactor()


def test_drift_baseline_absorbs_training_error(session_seed):
    rng = _rng(session_seed, 5)
    X = torch.from_numpy(rng.rand(10, K).astype(np.float32))
    H = torch.from_numpy(rng.rand(K, N).astype(np.float32))
    rows = X @ H + 0.01 * torch.from_numpy(rng.rand(10, N).astype(
        np.float32))
    rel = float(torch.linalg.norm(rows - X @ H) / torch.linalg.norm(rows))
    noisy = DriftAccumulator(N, baseline_rel_err=0.0)
    noisy.observe(rows, X, H)
    calibrated = DriftAccumulator(N, baseline_rel_err=rel * 1.05)
    calibrated.observe(rows, X, H)
    assert calibrated.total < noisy.total and calibrated.total < 1e-4


def test_drift_localises_to_corrupted_block(session_seed):
    rng = _rng(session_seed, 6)
    X = torch.from_numpy(rng.rand(10, K).astype(np.float32))
    H = torch.from_numpy(rng.rand(K, N).astype(np.float32))
    rows = (X @ H).clone()
    sl = block_slices(N, 8)[3]
    rows[:, sl] += 5.0
    acc = DriftAccumulator(N, n_blocks=8, block_threshold=0.01)
    acc.observe(rows, X, H)
    touched = acc.touched()
    assert touched[3] and touched.sum() == 1
    mask = acc.column_mask()
    assert mask[sl].all() and mask.sum() == sl.stop - sl.start
    acc.reset(touched)
    assert acc.total == 0.0


def test_drift_reset_all_rebases_baseline():
    acc = DriftAccumulator(N, baseline_rel_err=0.1)
    acc._drift[:] = 1.0
    assert acc.should_refactor()
    acc.reset_all(baseline_rel_err=0.2)
    assert acc.total == 0.0 and acc.baseline_rel_err == 0.2


@pytest.mark.parametrize("n,b", [(64, 8), (65, 8), (7, 3), (8, 8),
                                 (13_824, 8), (1_001, 7)])
def test_block_slices_equal_the_jax_packages(n, b):
    from repro.online import block_slices as jax_slices
    sls = block_slices(n, b)
    assert sls == jax_slices(n, b)
    cover = np.concatenate([np.arange(s.start, s.stop) for s in sls])
    np.testing.assert_array_equal(cover, np.arange(n))
    widths = [s.stop - s.start for s in sls]
    assert max(widths) - min(widths) <= 1


@pytest.mark.parametrize("n,n_blocks", [(64, 8), (65, 8), (300, 7)])
def test_drift_energies_match_the_jax_packages(n, n_blocks, session_seed):
    import jax.numpy as jnp
    from repro.online import block_residual_energy as jax_energy
    rng = _rng(session_seed, 7)
    rows, X, H = (rng.rand(*s).astype(np.float32)
                  for s in ((12, n), (12, K), (K, n)))
    got = block_residual_energy(*map(torch.from_numpy, (rows, X, H)),
                                n_blocks=n_blocks)
    want = jax_energy(jnp.asarray(rows), jnp.asarray(X), jnp.asarray(H),
                      n_blocks=n_blocks)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_drift_validates_args():
    with pytest.raises(ValueError):
        DriftAccumulator(8, n_blocks=9)
    with pytest.raises(ValueError):
        DriftAccumulator(8, block_threshold=-1.0)


# ---------------------------------------------------- batcher payloads ----

def test_batcher_delivers_list_payloads_verbatim():
    def project(rows):
        return [("payload", i, float(rows[i, 0])) for i in range(len(rows))]
    with MicroBatcher(project, max_batch=4, max_delay_s=1e-3) as mb:
        futs = [mb.submit(np.full((3,), float(i), np.float32))
                for i in range(6)]
        for i, f in enumerate(futs):
            tag, _, v = f.result(timeout=30)
            assert tag == "payload" and v == float(i)


# ------------------------------------------------------- chaos check ------

def test_swap_chaos_never_mixes_versions(A0, trained, session_seed):
    """4 live client threads under a publisher that keeps swapping: every
    future resolves exactly once, and every response's code matches an
    independent cold projection at the version it is STAMPED with."""
    probes = _batch(session_seed, 9, 4)
    arts, results, errors = {}, [], []
    stop = threading.Event()
    lock = threading.Lock()
    with _svc(A0, result=trained, n_blocks=8, block_threshold=0.05,
              full_threshold=np.inf) as svc:
        arts[0] = svc.artifact

        def client(tid):
            try:
                futs = []
                while not stop.is_set():
                    futs.append(svc.submit(probes[tid]))
                    time.sleep(0.001)
                for f in futs:
                    r = f.result(timeout=60)
                    with lock:
                        results.append((tid, r))
            except Exception as e:               # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for step in range(1, 7):
            rep = svc.ingest(_batch(session_seed, step, 12, drift=0.4))
            arts[rep.version] = svc.artifact
        stop.set()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        latest = svc.version
    assert results
    expected = {v: FoldInProjector(a, **CPU).project(probes)
                for v, a in arts.items()}
    mixed = sum(not torch.allclose(r.code, expected[r.version][tid],
                                   atol=1e-5, rtol=0)
                for tid, r in results)
    assert all(r.version <= latest and r.version in arts
               for _, r in results)
    assert mixed == 0, f"{mixed}/{len(results)} responses inconsistent"


def test_stats_accounting(A0, trained, session_seed):
    with _svc(A0, result=trained, block_threshold=np.inf,
              full_threshold=np.inf) as svc:
        svc.project(A0[:5])
        assert svc.stats.queries == 5 and svc.stats.stale_queries == 0
        assert svc.stats.served_by_version[0] == 5
        svc.ingest(_batch(session_seed, 1, 4))
        svc.project(A0[:3])
        assert svc.stats.served_by_version[1] == 3
        svc._record_serve(2, svc.version - 1)
        assert svc.stats.stale_queries == 2
        assert 0.0 < svc.stats.staleness < 1.0
        _, _, v = svc.retrieve(A0[:2], k=3)
        assert v == 1


def test_mesh_serves_the_same_codes(A0, trained, session_seed):
    mesh = serve_mesh(2, devices=["cpu", "cpu"])
    rows = _batch(session_seed, 1, 8)
    with _svc(A0, result=trained, mesh=mesh, block_threshold=np.inf,
              full_threshold=np.inf) as svc, \
            _svc(A0, result=trained, block_threshold=np.inf,
                 full_threshold=np.inf) as one:
        svc.ingest(rows)
        one.ingest(rows)
        got, want = svc.project(A0[:5]), one.project(A0[:5])
        assert got.version == want.version == 1
        torch.testing.assert_close(got.code, want.code, atol=1e-5, rtol=0)
        _, idx, v = svc.retrieve(A0[:2], k=3)
        assert v == 1 and tuple(idx.shape) == (2, 3)


# --------------------------------------------- property sweep vs oracle ---

@settings(max_examples=4, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=6), min_size=1,
                max_size=4))
def test_random_schedules_track_scratch_oracle(schedule):
    """Any ingest schedule keeps the online model within the declared
    envelope of retraining from scratch: rel_err ≤ oracle · 2 + 0.05.
    Each entry s is one batch of 8·⌈s/2⌉ rows, delivered sparse (~70 %
    zeroed) when s is even."""
    seed, n, k = 1234, 48, 4
    mk = lambda step, rows, **kw: stream_batch(seed, step, rows=rows, n=n,
                                               k=k, device="cpu", **kw)
    A0 = mk(0, 32, noise=0.01)
    batches, dense = [], []
    for i, s in enumerate(schedule):
        rows = mk(1 + i, 8 * ((s + 1) // 2), drift=0.15, noise=0.01)
        if s % 2 == 0:
            keep = torch.from_numpy(np.random.RandomState(100 + i).rand(
                *rows.shape) < 0.3)
            rows = rows * keep
            batches.append(rows.to_sparse())
        else:
            batches.append(rows)
        dense.append(rows)
    with OnlineNMF(A0, k=k, algo="bpp", seed=seed, n_blocks=6,
                   block_threshold=0.1, full_threshold=1.0, device="cpu",
                   max_delay_s=1e-4) as svc:
        for b in batches:
            svc.ingest(b)
        online, m_total = svc.rel_err(), svc.shape[0]
    A_acc = torch.cat([A0] + dense)
    assert A_acc.shape[0] == m_total
    oracle = NMFSolver(k, algo="bpp", max_iters=50, tol=1e-5,
                       device="cpu").fit(A_acc, seed=seed)
    assert online <= float(oracle.rel_errors[-1]) * 2.0 + 0.05


def test_replay_is_bit_identical(A0, session_seed):
    def run():
        with _svc(A0, algo="hals", seed=session_seed, n_blocks=8,
                  block_threshold=0.05, full_threshold=np.inf) as svc:
            reports = [svc.ingest(_batch(session_seed, step, 8, drift=0.3))
                       for step in range(1, 5)]
            return (svc.W, svc.H, [r.action for r in reports],
                    [r.version for r in reports], svc.drift.drift)
    W1, H1, acts1, vers1, d1 = run()
    W2, H2, acts2, vers2, d2 = run()
    assert acts1 == acts2 and vers1 == vers2
    assert torch.equal(W1, W2) and torch.equal(H1, H2)
    np.testing.assert_array_equal(d1, d2)


# ------------------------------------------------ against the JAX package --

BLOCK_T, FULL_T = 0.05, 0.5
SCRIPT = ("clean", "block", "clean", "noise", "clean", "block", "clean")


def _script(seed):
    """The scripted stream, as numpy: planted rows; a batch whose block 3
    is tripled (a refresh of that block); a batch of one spike a row, which
    no nonnegative mix of H's rows explains (a refactorization)."""
    from repro.data.pipeline import stream_batch as jax_batch
    out = []
    for step, kind in enumerate(SCRIPT, 1):
        rows = np.array(jax_batch(seed, step, rows=16, n=N, k=K,
                                  noise=0.01), np.float32)
        if kind == "block":
            rows[:, block_slices(N, 8)[3]] *= 3.0
        if kind == "noise":
            cols = np.random.default_rng(step).integers(0, N, 16)
            rows = np.zeros((16, N), np.float32)
            rows[np.arange(16), cols] = 10.0
        out.append(rows)
    return out


def _run_script(svc, script):
    """Each batch's report, and the drift the decision read (before a
    refresh or refactor resets it)."""
    seen = []
    observe = svc.drift.observe

    def spy(*args):
        excess = observe(*args)
        seen.append(svc.drift.drift)
        return excess

    svc.drift.observe = spy
    return [svc.ingest(rows) for rows in script], seen


def _assert_margins(seen, reports):
    for drift, rep in zip(seen, reports):
        total = float(drift.sum())
        assert abs(total - FULL_T) > 0.25 * FULL_T, (rep, total)
        if rep.action != "refactor":
            assert np.min(np.abs(drift - BLOCK_T)) > 0.25 * BLOCK_T, \
                (rep, drift)


def test_scripted_stream_takes_the_jax_packages_actions(session_seed):
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.data.pipeline import stream_batch as jax_batch
    from repro.online import OnlineNMF as JaxOnline
    A0 = np.asarray(jax_batch(session_seed, 0, rows=48, n=N, k=K,
                              noise=0.01), np.float32)
    shared = JaxSolver(K, algo="bpp", max_iters=200, tol=1e-5).fit(
        jnp.asarray(A0), key=jax.random.PRNGKey(session_seed))
    kw = dict(k=K, algo="bpp", result=shared, n_blocks=8,
              block_threshold=BLOCK_T, full_threshold=FULL_T,
              max_delay_s=1e-4)
    script = _script(session_seed)
    with JaxOnline(A0, solver=JaxSolver(K, algo="bpp", max_iters=5),
                   **kw) as js:
        j_reports, j_seen = _run_script(js, script)
        jW, jH = np.asarray(js.W), np.asarray(js.H)
    with OnlineNMF(A0, solver=NMFSolver(K, algo="bpp", max_iters=5, **CPU),
                   **kw) as ts:
        t_reports, t_seen = _run_script(ts, script)
        tW, tH = ts.W.numpy(), ts.H.numpy()
    _assert_margins(j_seen, j_reports)
    _assert_margins(t_seen, t_reports)
    assert [r.action for r in t_reports] == [r.action for r in j_reports]
    assert {"extend", "refresh", "refactor"} <= {r.action for r in t_reports}
    for t, j in zip(t_reports, j_reports):
        assert (t.version, t.rows, t.touched_blocks) == \
            (j.version, j.rows, j.touched_blocks)
        np.testing.assert_allclose(t.drift_total, j.drift_total, rtol=1e-4,
                                   atol=1e-7)
    for got, want in ((tW, jW), (tH, jH)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


def test_from_checkpoint_of_a_jax_run(tmp_path, session_seed):
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.elastic import ElasticRunner as JaxRunner
    A0 = _batch(session_seed, 0, 48, noise=0.01).numpy()
    JaxRunner(JaxSolver(K, algo="mu", max_iters=10), str(tmp_path),
              segment_iters=5).fit(jnp.asarray(A0),
                                   key=jax.random.PRNGKey(session_seed))
    with OnlineNMF.from_checkpoint(A0, str(tmp_path), device="cpu",
                                   max_delay_s=1e-4) as svc:
        assert svc.artifact.version == 0 and svc._rule.name == "mu"
        assert svc.artifact.meta["iters"] == 10
        rep = svc.ingest(_rng(session_seed, 8).rand(4, N).astype(
            np.float32))
        assert rep.version == 1 and svc.shape == (52, N)
    with pytest.raises(ValueError, match="rank"):
        OnlineNMF.from_checkpoint(A0, str(tmp_path), k=K + 1, device="cpu")
