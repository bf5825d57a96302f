"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``: the registry, tracer and logging shim run the
cases of tests/test_obs.py (and give the JAX package's Prometheus and
JSONL text for the same calls); ``fit(profile=True)`` gives the unprofiled
fit's bits with the reference's phase keys and agrees with the JAX
package's profiled fit (serial, faun 1×1 and gspmd 1×1 in this process on
a one-rank gloo group; faun 2×2, gspmd 2×2 and naive p = 2 on spawned
gloo ranks, against the JAX serial engine's profiled fit); the breakdown
report's predicted column equals the JAX package's.

The rank bodies are top-level functions of this module, which imports no
JAX at its top: the spawned ranks never import JAX.
"""

import json
import logging
import math
import os
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import costmodel
from repro_torch.core.engine import NMFSolver
from repro_torch.obs.log import get_logger, log_event
from repro_torch.obs.metrics import (LATENCY_BUCKETS_S, SIZE_BUCKETS,
                                     MetricsRegistry, default_registry,
                                     next_instance_label)
from repro_torch.obs.phases import expected_phases, phase_group
from repro_torch.obs.report import (breakdown_report, format_report,
                                    merge_phase_times, run_all_schedules)
from repro_torch.obs.trace import Tracer, default_tracer, span
from repro_torch.serve.batcher import BatcherStats, MicroBatcher
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
ITERS = 3
SCHEDULES = ("serial", "faun", "naive", "gspmd")
ALGOS = ("mu", "hals", "bpp")


def _problem(seed=0, m=M, n=N, k=K, noise=0.5):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + noise * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0


def _assert_scaled(got, want, atol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# Metrics registry (tests/test_obs.py::TestMetricsRegistry)
# ---------------------------------------------------------------------------

def _same_calls(reg):
    """One sequence of registry calls, run against either package."""
    reg.counter("req_total", labels={"instance": "0"},
                help="requests").inc(3)
    g = reg.gauge("depth", help="queue depth")
    g.set(7)
    g.inc(-2.5)
    h = reg.histogram("lat_s", buckets=(0.1, 1.0), help="latency")
    for v in (0.05, 0.5, 7.0):
        h.observe(v)
    s = reg.histogram("size", buckets=SIZE_BUCKETS,
                      labels={"instance": "3"})
    for v in (1, 3, 64, 5000):
        s.observe(v)
    reg.histogram("lat_default_s").observe(2e-3)


class TestMetricsRegistry:
    def test_counter_gauge_histogram_basics(self):
        reg = MetricsRegistry()
        c = reg.counter("c_total")
        c.inc()
        c.inc(3)
        assert c.value == 4
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("g")
        g.set(7)
        g.inc(-2)
        assert g.value == 5
        h = reg.histogram("h_s", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        assert h.count == 3 and h.counts == (1, 1, 1)
        assert h.max == 5.0 and abs(h.mean - 5.55 / 3) < 1e-12
        assert h.quantile(0.5) == 1.0
        assert h.quantile(1.0) == 5.0
        with pytest.raises(ValueError):
            h.quantile(1.5)

    def test_get_or_create_is_idempotent_and_kind_checked(self):
        reg = MetricsRegistry()
        assert reg.counter("x") is reg.counter("x")
        assert reg.counter("x", labels={"a": "1"}) is not reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")

    def test_thread_safety_four_writers(self):
        reg = MetricsRegistry()
        c = reg.counter("writes_total")
        h = reg.histogram("vals", buckets=(0.5,))
        N_W, THREADS = 5_000, 4

        def writer():
            for i in range(N_W):
                c.inc()
                h.observe(i % 2)

        threads = [threading.Thread(target=writer) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert c.value == N_W * THREADS
        assert h.count == N_W * THREADS
        assert sum(h.counts) == N_W * THREADS

    def test_prometheus_exposition_golden(self):
        reg = MetricsRegistry()
        reg.counter("req_total", labels={"instance": "0"},
                    help="requests").inc(3)
        h = reg.histogram("lat_s", buckets=(0.1, 1.0), help="latency")
        h.observe(0.05)
        h.observe(0.5)
        h.observe(7.0)
        expected = (
            "# HELP req_total requests\n"
            "# TYPE req_total counter\n"
            'req_total{instance="0"} 3\n'
            "# HELP lat_s latency\n"
            "# TYPE lat_s histogram\n"
            'lat_s_bucket{le="0.1"} 1\n'
            'lat_s_bucket{le="1"} 2\n'
            'lat_s_bucket{le="+Inf"} 3\n'
            "lat_s_sum 7.55\n"
            "lat_s_count 3\n")
        assert reg.to_prometheus() == expected

    def test_prometheus_and_jsonl_equal_the_reference(self, tmp_path):
        from repro.obs.metrics import MetricsRegistry as JaxRegistry
        port, ref = MetricsRegistry(), JaxRegistry()
        _same_calls(port)
        _same_calls(ref)
        assert port.to_prometheus() == ref.to_prometheus()
        assert port.snapshot() == ref.snapshot()
        port.export_jsonl(str(tmp_path / "port.jsonl"))
        ref.export_jsonl(str(tmp_path / "ref.jsonl"))
        a = json.loads((tmp_path / "port.jsonl").read_text())
        b = json.loads((tmp_path / "ref.jsonl").read_text())
        assert set(a) == set(b) == {"time", "metrics"}
        assert a["metrics"] == b["metrics"]

    def test_bucket_ladders_equal_the_reference(self):
        from repro.obs import metrics as jm
        assert LATENCY_BUCKETS_S == jm.LATENCY_BUCKETS_S
        assert SIZE_BUCKETS == jm.SIZE_BUCKETS
        a, b = next_instance_label(), next_instance_label()
        assert a != b and a.isdigit() and b.isdigit()

    def test_snapshot_and_jsonl_export(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("a_total").inc(2)
        reg.histogram("b_s", buckets=(1.0,)).observe(0.5)
        path = tmp_path / "metrics.jsonl"
        reg.export_jsonl(str(path))
        reg.export_jsonl(str(path))            # appends
        lines = path.read_text().splitlines()
        assert len(lines) == 2
        rec = json.loads(lines[-1])
        assert rec["metrics"]["a_total"] == 2
        assert rec["metrics"]["b_s"]["count"] == 1

    def test_default_registry_is_a_process_singleton(self):
        assert default_registry() is default_registry()


# ---------------------------------------------------------------------------
# Tracing (tests/test_obs.py::TestTracer)
# ---------------------------------------------------------------------------

class TestTracer:
    def test_span_nesting_and_export_round_trip(self, tmp_path):
        tr = Tracer()
        with tr.span("outer", batch=4):
            with tr.span("inner"):
                time.sleep(0.002)
        spans = {e.name: e for e in tr.spans()}
        assert set(spans) == {"outer", "inner"}
        inner, outer = spans["inner"], spans["outer"]
        assert outer.ts_us <= inner.ts_us
        assert inner.ts_us + inner.dur_us <= outer.ts_us + outer.dur_us + 1
        assert dict(outer.args)["batch"] == 4
        path = tmp_path / "trace.json"
        tr.export(str(path))
        doc = json.loads(path.read_text())
        assert sorted(e["name"] for e in doc["traceEvents"]) == [
            "inner", "outer"]
        ev = doc["traceEvents"][0]
        assert ev["ph"] == "X" and ev["dur"] > 0 and "pid" in ev

    def test_chrome_json_has_the_reference_layout(self, tmp_path):
        from repro.obs.trace import Tracer as JaxTracer
        docs = []
        for cls in (Tracer, JaxTracer):
            tr = cls(max_events=2)
            for i in range(3):
                tr.record(f"s{i}", 1.0, 1.5, (("batch", i),))
            path = tmp_path / f"{cls.__module__}.json"
            tr.export(str(path))
            doc = json.loads(path.read_text())
            for ev in doc["traceEvents"]:
                ev.pop("ts"), ev.pop("tid")    # epoch and thread differ
            docs.append(doc)
        assert docs[0] == docs[1]

    def test_disabled_tracer_is_free_and_records_nothing(self):
        tr = Tracer(enabled=False)
        with tr.span("nope"):
            pass
        tr.record("nope", 0.0, 1.0)
        assert tr.spans() == []
        assert not default_tracer().enabled or default_tracer() is not tr
        with span("default-disabled"):
            pass

    def test_bounded_buffer_counts_drops(self):
        tr = Tracer(max_events=2)
        for i in range(5):
            tr.record(f"s{i}", 0.0, 1.0)
        assert len(tr.spans()) == 2 and tr.dropped == 3
        tr.clear()
        assert tr.spans() == [] and tr.dropped == 0


# ---------------------------------------------------------------------------
# Structured logging shim
# ---------------------------------------------------------------------------

def test_log_event_renders_and_carries_fields(caplog):
    from repro.obs.log import log_event as jax_log_event
    log = get_logger("serve.test")
    assert log.name == "repro_torch.serve.test"
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.test"):
        msg = log_event(log, "swap_refused", served_version=3,
                        offered_version=1, note="a b")
    assert msg == ('swap_refused served_version=3 offered_version=1 '
                   'note="a b"')
    rec = caplog.records[-1]
    assert rec.event == "swap_refused"
    assert rec.fields["offered_version"] == 1
    assert msg == jax_log_event(logging.getLogger("unit"), "swap_refused",
                                served_version=3, offered_version=1,
                                note="a b")


# ---------------------------------------------------------------------------
# Stats views (tests/test_obs.py::TestBatcherStatsView)
# ---------------------------------------------------------------------------

class TestBatcherStatsView:
    def test_bounded_batch_sizes_window(self):
        stats = BatcherStats(MetricsRegistry())
        n = BatcherStats.RECENT_WINDOW + 50
        for i in range(n):
            stats.record_batch(1 + i % 4)
        assert stats.batches == n
        assert stats.requests == sum(1 + i % 4 for i in range(n))
        assert len(stats.batch_sizes) == BatcherStats.RECENT_WINDOW
        assert stats.max_batch_seen == 4
        assert stats.mean_batch == pytest.approx(stats.requests / n)

    def test_batcher_records_into_injected_registry(self):
        reg = MetricsRegistry()
        with MicroBatcher(lambda rows: np.asarray(rows) * 2.0, max_batch=4,
                          registry=reg) as mb:
            futs = [mb.submit(np.full((3,), float(i))) for i in range(8)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(timeout=30),
                                           np.full((3,), 2.0 * i))
        assert mb.stats.requests == 8
        snap = reg.snapshot()
        req_keys = [k for k in snap
                    if k.startswith("serve_batcher_requests_total")]
        assert len(req_keys) == 1 and snap[req_keys[0]] == 8
        text = reg.to_prometheus()
        assert "serve_batcher_batch_size_bucket" in text
        assert "serve_batcher_batch_latency_s_bucket" in text

    def test_two_batchers_do_not_mix_series(self):
        reg = MetricsRegistry()
        a, b = BatcherStats(reg), BatcherStats(reg)
        a.record_batch(5)
        assert a.requests == 5 and b.requests == 0

    def test_series_names_equal_the_reference(self):
        from repro.obs.metrics import MetricsRegistry as JaxRegistry
        from repro.serve.batcher import BatcherStats as JaxStats
        names = []
        for stats_cls, reg_cls in ((BatcherStats, MetricsRegistry),
                                   (JaxStats, JaxRegistry)):
            reg = reg_cls()
            stats_cls(reg).record_batch(3, 0.01)
            names.append(sorted((m.name, type(m).__name__)
                                for m in reg.collect()))
        assert names[0] == names[1]


def test_foldin_and_topk_record_into_default_registry():
    from repro_torch.serve.artifact import FactorArtifact
    from repro_torch.serve.foldin import FoldInProjector
    from repro_torch.serve.topk import TopK
    A, W0, H0 = _problem()
    res = NMFSolver(K, algo="bpp", max_iters=5, device="cpu").fit(
        A, W0=W0, H0=H0)
    art = FactorArtifact.from_result(res)
    reg = default_registry()
    rows0 = reg.counter("serve_foldin_rows_total").value
    q0 = reg.counter("serve_topk_queries_total").value
    lat0 = reg.histogram("serve_foldin_project_latency_s").count
    tr = default_tracer()
    tr.enable()
    try:
        proj = FoldInProjector(art, max_batch=8, device="cpu")
        codes = proj.project(A[:5])
        assert codes.shape == (5, K)
        TopK(art).query(codes, k=3)
    finally:
        tr.disable()
    assert reg.counter("serve_foldin_rows_total").value >= rows0 + 5
    assert reg.counter("serve_topk_queries_total").value == q0 + 1
    assert reg.histogram("serve_foldin_project_latency_s").count > lat0
    assert reg.histogram("serve_topk_query_latency_s").count > 0
    names = {e.name for e in tr.spans()}
    assert {"foldin.project", "topk.query"} <= names
    tr.clear()


# ---------------------------------------------------------------------------
# Phase profiling: keys, bits, the wall-clock envelope
# ---------------------------------------------------------------------------

def test_expected_phases_and_groups_equal_the_reference():
    from repro.obs.phases import expected_phases as jax_expected
    from repro.obs.phases import phase_group as jax_group
    for schedule in SCHEDULES:
        assert expected_phases(schedule) == jax_expected(schedule)
        for key in expected_phases(schedule):
            assert phase_group(key) == jax_group(key)
    with pytest.raises(ValueError):
        expected_phases("ring")
    assert phase_group("gram_w") == "gram"
    assert phase_group("allreduce_gram_h") == "comm"
    assert phase_group("reduce_scatter_w") == "comm"
    assert phase_group("allgather_h") == "comm"
    assert phase_group("luc_h") == "luc"
    assert phase_group("error") == "error"
    assert phase_group("other_thing") == "other"


@pytest.mark.parametrize("algo", ALGOS + ("amu", "ahals"))
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_profiled_fit_is_bit_equal_to_the_unprofiled_fit(algo, backend):
    A, W0, H0 = _problem()
    solver = NMFSolver(K, algo=algo, backend=backend, device="cpu",
                       max_iters=ITERS)
    plain = solver.fit(A, W0=W0, H0=H0)
    prof = solver.fit(A, W0=W0, H0=H0, profile=True)
    for key in ("W", "H", "rel_errors"):
        assert torch.equal(getattr(prof, key), getattr(plain, key)), key
    assert prof.iters == plain.iters == ITERS
    assert set(prof.extras["phase_times"]) == set(expected_phases("serial"))
    assert prof.extras["rule_state"] == plain.extras["rule_state"]


def test_profiled_sparse_fit_is_bit_equal():
    from repro_torch.backends import SparseOps
    from repro_torch.data.pipeline import erdos_renyi_bcoo
    S = erdos_renyi_bcoo(torch.Generator().manual_seed(0), M, N, 0.2)
    for impl in ("scatter", "sorted"):
        solver = NMFSolver(K, algo="mu", backend=SparseOps(spmm_impl=impl),
                           device="cpu", max_iters=ITERS)
        a, b = solver.fit(S, seed=2), solver.fit(S, seed=2, profile=True)
        assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)
        assert torch.equal(a.rel_errors, b.rel_errors)


def test_profiled_bf16_carry_is_bit_equal():
    A, W0, H0 = _problem()
    At = torch.from_numpy(A).to(torch.bfloat16)
    for algo, backend in (("mu", "cuda"), ("hals", "cuda"),
                          ("bpp", "dense")):
        solver = NMFSolver(K, algo=algo, backend=backend, device="cpu",
                           max_iters=2)
        a = solver.fit(At, W0=W0, H0=H0)
        b = solver.fit(At, W0=W0, H0=H0, profile=True)
        assert b.W.dtype == torch.bfloat16
        assert torch.equal(a.W, b.W) and torch.equal(a.H, b.H)


def test_phase_times_fit_inside_the_wall_clock():
    A, W0, H0 = _problem()
    solver = NMFSolver(K, algo="mu", device="cpu", max_iters=ITERS)
    solver.fit(A, W0=W0, H0=H0, profile=True)
    t0 = time.perf_counter()
    res = solver.fit(A, W0=W0, H0=H0, profile=True)
    wall = time.perf_counter() - t0
    pt = res.extras["phase_times"]
    assert all(v >= 0 for v in pt.values())
    total = sum(pt.values()) * res.iters
    assert total <= wall
    assert total >= wall / 2 or wall < 0.05


def test_profile_adaptive_stopping_matches_the_unprofiled_fit():
    A, W0, H0 = _problem()
    for kw in (dict(tol=0.2), dict(stall_iters=2, stall_tol=1e-3)):
        solver = NMFSolver(K, algo="mu", device="cpu", max_iters=60, **kw)
        a = solver.fit(A, W0=W0, H0=H0)
        b = solver.fit(A, W0=W0, H0=H0, profile=True)
        assert b.iters == a.iters < 60 and b.extras["stopped_early"]
        assert len(b.rel_errors) == b.iters
        assert torch.equal(a.rel_errors, b.rel_errors)
        assert torch.equal(a.W, b.W)


def test_profile_tracer_records_segments():
    tr = Tracer()
    A, W0, H0 = _problem()
    NMFSolver(K, algo="mu", device="cpu", max_iters=2).fit(
        A, W0=W0, H0=H0, profile=True, tracer=tr)
    spans = tr.spans()
    names = {e.name for e in spans}
    assert names == {f"phase.{p}" for p in expected_phases("serial")} | {
        "phase.iteration"}
    assert len(spans) == 2 * (len(expected_phases("serial")) + 1)
    assert {dict(e.args)["iteration"] for e in spans} == {0, 1}


def test_profile_refuses_wire_format_knobs():
    """As the reference: profile=True times the exact wire only."""
    from repro_torch.core.faun import make_faun_grid
    A, W0, H0 = _problem()
    with rdist.one_rank_group(torch.device("cpu")):
        grid = make_faun_grid(1, 1)
        for kw, knob in ((dict(panel_compression="int8"),
                          "panel_compression"),
                         (dict(panel_dtype=torch.bfloat16), "panel_dtype")):
            solver = NMFSolver(K, schedule="faun", grid=grid, device="cpu",
                               **kw)
            with pytest.raises(ValueError, match=knob):
                solver.fit(A, W0=W0, H0=H0, profile=True)


def test_profile_zero_iterations():
    A, W0, H0 = _problem()
    res = NMFSolver(K, algo="mu", device="cpu", max_iters=0).fit(
        A, W0=W0, H0=H0, profile=True)
    assert res.iters == 0 and res.extras["phase_times"] == {}


# ---------------------------------------------------------------------------
# Against the JAX package's profiled fits
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_profiled():
    """The JAX package's profiled fits on one device: serial for each algo
    (the oracle of every schedule), and faun / gspmd at 1×1 (their keys)."""
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    A, W0, H0 = _problem()
    out = {}
    for algo in ALGOS:
        for schedule in ("serial", "faun", "naive", "gspmd"):
            res = JaxSolver(K, algo=algo, schedule=schedule,
                            max_iters=ITERS).fit(
                jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0),
                profile=True)
            out[algo, schedule] = {
                "W": np.asarray(res.W), "H": np.asarray(res.H),
                "rels": np.asarray(res.rel_errors),
                "keys": sorted(res.extras["phase_times"])}
    return out


@pytest.fixture(scope="module")
def one_rank_fits():
    """The port's profiled and unprofiled fits of every schedule on a
    one-rank gloo group in this process."""
    from repro_torch.core.faun import make_faun_grid
    A, W0, H0 = _problem()
    out = {}
    with rdist.one_rank_group(torch.device("cpu")):
        grid = make_faun_grid(1, 1)
        for algo in ALGOS:
            for schedule in SCHEDULES:
                kw = dict(algo=algo, schedule=schedule, device="cpu",
                          max_iters=ITERS,
                          backend="dense" if schedule == "gspmd" else "cuda")
                if schedule != "naive":
                    kw["grid"] = grid
                solver = NMFSolver(K, **kw)
                out[algo, schedule] = (
                    solver.fit(A, W0=W0, H0=H0),
                    solver.fit(A, W0=W0, H0=H0, profile=True))
    return out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_one_rank_profiled_fit_against_jax(one_rank_fits, jax_profiled,
                                           algo, schedule):
    plain, prof = one_rank_fits[algo, schedule]
    ref = jax_profiled[algo, schedule]
    assert sorted(prof.extras["phase_times"]) == ref["keys"]
    assert set(ref["keys"]) == set(expected_phases(schedule))
    _assert_scaled(prof.W.numpy(), ref["W"], 1e-4)
    _assert_scaled(prof.H.numpy(), ref["H"], 1e-4)
    np.testing.assert_allclose(prof.rel_errors.numpy(), ref["rels"],
                               rtol=1e-4)
    assert torch.equal(prof.W, plain.W) and torch.equal(prof.H, plain.H)
    assert torch.equal(prof.rel_errors, plain.rel_errors)


def _grid_rank(out):
    """faun and gspmd on a 2×2 grid of 4 gloo ranks; rank 0 writes."""
    from repro_torch.core.faun import make_faun_grid
    A, W0, H0 = _problem()
    grid = make_faun_grid(2, 2)
    for algo in ALGOS:
        for schedule, backend in (("faun", "cuda"), ("gspmd", "dense")):
            solver = NMFSolver(K, algo=algo, schedule=schedule, grid=grid,
                               backend=backend, device="cpu",
                               max_iters=ITERS)
            plain = solver.fit(A, W0=W0, H0=H0)
            prof = solver.fit(A, W0=W0, H0=H0, profile=True)
            _save_pair(out, f"{schedule}_2x2_{algo}", plain, prof)


def _naive_rank(out):
    """naive on 2 gloo ranks; rank 0 writes."""
    A, W0, H0 = _problem()
    for algo in ALGOS:
        solver = NMFSolver(K, algo=algo, schedule="naive", device="cpu",
                           max_iters=ITERS)
        plain = solver.fit(A, W0=W0, H0=H0)
        prof = solver.fit(A, W0=W0, H0=H0, profile=True)
        _save_pair(out, f"naive_p2_{algo}", plain, prof)


def _save_pair(out, tag, plain, prof):
    if dist.get_rank() != 0:
        return
    np.savez(os.path.join(out, f"{tag}.npz"),
             W=plain.W.numpy(), H=plain.H.numpy(),
             rels=plain.rel_errors.numpy(), pW=prof.W.numpy(),
             pH=prof.H.numpy(), prels=prof.rel_errors.numpy(),
             keys=np.array(sorted(prof.extras["phase_times"])),
             grid=np.array(prof.extras["grid"]))


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("obs_ranks"))
    rdist.spawn(_grid_rank, 4, out, device="cpu")
    rdist.spawn(_naive_rank, 2, out, device="cpu")
    return out


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("tag", ["faun_2x2", "gspmd_2x2", "naive_p2"])
def test_grid_profiled_fit_against_jax(grid_runs, jax_profiled, tag, algo):
    """Phase keys equal the JAX profiled fit's of that schedule; W and H
    within a scaled 1e-4 and the rel errors within rtol 1e-4 of the JAX
    serial engine's profiled fit (one device holds no 2×2 grid); the
    profiled fit equals the unprofiled one bit for bit."""
    got = np.load(os.path.join(grid_runs, f"{tag}_{algo}.npz"))
    schedule = tag.split("_")[0]
    assert list(got["keys"]) == jax_profiled[algo, schedule]["keys"]
    ref = jax_profiled[algo, "serial"]
    _assert_scaled(got["pW"], ref["W"], 1e-4)
    _assert_scaled(got["pH"], ref["H"], 1e-4)
    np.testing.assert_allclose(got["prels"], ref["rels"], rtol=1e-4)
    for a, b in (("W", "pW"), ("H", "pH"), ("rels", "prels")):
        np.testing.assert_array_equal(got[a], got[b])
    assert tuple(got["grid"]) == ((2, 1) if schedule == "naive" else (2, 2))


# ---------------------------------------------------------------------------
# The measured-against-predicted report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reports():
    return run_all_schedules(m=M, n=N, k=8, iters=ITERS, device="cpu")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_report_joins_without_nan(reports, schedule):
    rows = reports[schedule]
    groups = {r["group"] for r in rows}
    assert {"gram", "mm", "luc", "error"} <= groups
    assert ("comm" in groups) == (schedule in ("faun", "naive"))
    for r in rows:
        assert math.isfinite(r["measured_s"])
        assert math.isfinite(r["predicted_s"])
        if not isinstance(r["ratio"], str):
            assert math.isfinite(r["ratio"])
    table = format_report(rows, title=schedule)
    assert "nan" not in table.lower()
    assert len(table.splitlines()) == 1 + 1 + len(rows)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_report_predictions_equal_the_reference(reports, schedule):
    """The predicted column against the JAX package's ``breakdown_report``
    of the same schedule (1×1, the same problem size), rtol 1e-12."""
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.obs.report import breakdown_report as jax_report
    A = jax.random.uniform(jax.random.PRNGKey(0), (M, N), jnp.float32)
    solver = JaxSolver(8, algo="mu", schedule=schedule, backend="dense",
                       max_iters=ITERS)
    ref = jax_report(solver, solver.fit(A, profile=True), M, N)
    got = reports[schedule]
    assert [r["group"] for r in got] == [r["group"] for r in ref]
    for a, b in zip(got, ref):
        assert a["predicted_s"] == pytest.approx(b["predicted_s"],
                                                 rel=1e-12)


@pytest.mark.parametrize("pr,pc", [(2, 2), (4, 1), (1, 4)])
def test_grid_predictions_equal_the_reference(pr, pc):
    from repro.core import costmodel as jcm
    mach = costmodel.Machine(alpha=2e-6, beta=3e-11, gamma=1.5e-14)
    jmach = jcm.Machine(alpha=2e-6, beta=3e-11, gamma=1.5e-14)
    for schedule in SCHEDULES:
        for algo in ("mu", "hals", "bpp"):
            got = costmodel.schedule_cost_terms(
                schedule, 4096, 2048, 16, pr=pr, pc=pc, algo=algo,
                machine=mach)
            want = jcm.schedule_cost_terms(
                schedule, 4096, 2048, 16, pr=pr, pc=pc, algo=algo,
                machine=jmach)
            assert set(got) == set(want)
            for key in got:
                assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_merge_phase_times_and_report_validation():
    merged = merge_phase_times({"gram_w": 1.0, "gram_h": 2.0,
                                "allgather_h": 0.5, "reduce_scatter_w": 0.25,
                                "luc_w": 3.0, "error": 0.125})
    assert merged == {"gram": 3.0, "comm": 0.75, "luc": 3.0, "error": 0.125}
    A, W0, H0 = _problem()
    solver = NMFSolver(K, algo="mu", device="cpu", max_iters=1)
    with pytest.raises(ValueError, match="profile=True"):
        breakdown_report(solver, solver.fit(A, W0=W0, H0=H0), M, N)


def test_report_cli_runs_on_the_cpu(capsys):
    from repro_torch.obs import report
    report.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for schedule in SCHEDULES:
        assert f"-- {schedule} --" in out
    assert "nan" not in out.lower()


def test_cost_terms_partition_the_model_exactly():
    mach = costmodel.Machine()
    for schedule in SCHEDULES:
        for pr, pc in ((1, 1), (2, 2), (4, 1)):
            terms = costmodel.schedule_cost_terms(
                schedule, 4096, 2048, 16, pr=pr, pc=pc, algo="mu",
                machine=mach)
            total = costmodel.schedule_cost(schedule, 4096, 2048, 16,
                                            pr=pr, pc=pc, algo="mu")
            part = (terms["gram"] + terms["mm"] + terms["luc"]
                    + terms["comm"])
            assert part == pytest.approx(total.time(mach), rel=1e-9)
            assert terms["error"] > 0
