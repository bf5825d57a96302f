"""The port's cost model (``core/costmodel.py``), its hooks on the rules and
backends, ``core/algorithms.py`` and ``NMFSolver.predict_cost`` against the
JAX package's, formula for formula (rtol 1e-12), and the reference's own
cost-model tests mirrored (tests/test_misc_system.py:22-48,
tests/test_engine.py:178-200 and :369-412, tests/test_rules.py:330-362).

``predict_cost`` reads the schedule's grid: it runs on a 2×2 faun grid and
a naive group of 4 gloo ranks (spawned once), against the JAX cost model
at those shapes.
"""

import itertools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.backends import SparseOps
from repro_torch.core import algorithms, costmodel, rules
from repro_torch.core.engine import NMFSolver
from repro_torch.distributed.compression import compressed_words
from repro_torch.util import dist as rdist

FIELDS = ("flops", "words", "messages", "memory_words", "traffic_words")
SCHEDULES = ("serial", "faun", "naive", "gspmd")
# the port's backend → the JAX package's
BACKENDS = {"dense": "dense", "cuda": "pallas", "auto": "sparse:auto",
            "scatter": "sparse:scatter", "sorted": "sparse:sorted"}
SHAPES = [(1_013_400, 13_824, 50, 0.0), (16_777_216, 16_777_216, 50,
                                         144_835_113.0),
          (96, 64, 6, 1_536.0), (172_800, 115_200, 32, 1e7)]
GRIDS = [(1, 1), (2, 2), (4, 1), (1, 4), (8, 16)]


def _port_rule(spec):
    name, kw = spec
    return rules.get_rule(name) if not kw else {
        "amu": rules.AcceleratedMURule,
        "ahals": rules.AcceleratedHALSRule}[name](**kw)


def _jax_rule(spec):
    from repro.core import rules as jrules
    name, kw = spec
    return jrules.get_rule(name) if not kw else {
        "amu": jrules.AcceleratedMURule,
        "ahals": jrules.AcceleratedHALSRule}[name](**kw)


RULES = [("mu", {}), ("hals", {}), ("bpp", {}), ("abpp", {}), ("amu", {}),
         ("ahals", {}), ("amu", dict(inner_iters=1)),
         ("amu", dict(inner_iters=4, delta=0.0)),
         ("ahals", dict(inner_iters=None))]


def _port_backend(name):
    return (SparseOps(spmm_impl=name)
            if name in ("auto", "scatter", "sorted") else name)


def _jax_backend(name):
    from repro.backends import SparseOps as JaxSparseOps
    spec = BACKENDS[name]
    if spec.startswith("sparse:"):
        return JaxSparseOps(spmm_impl=spec.split(":")[1])
    return spec


def _assert_close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0), (got, want)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_cost_matches_the_reference(schedule, backend):
    """Every IterCost field and every schedule_cost_terms entry, over
    rules × shapes × grids × compression."""
    from repro.core import costmodel as jcostmodel
    for spec, (m, n, k, nnz), (pr, pc), comp in itertools.product(
            RULES, SHAPES, GRIDS, (None, "int8")):
        if schedule == "serial" and ((pr, pc) != (1, 1) or comp):
            continue
        port_rule = _port_rule(spec).prepare_global(m, n, k)
        jax_rule = _jax_rule(spec).prepare_global(m, n, k)
        kw = dict(pr=pr, pc=pc, nnz=nnz, bpp_iters=1.7, compression=comp)
        got = costmodel.schedule_cost(schedule, m, n, k, algo=port_rule,
                                      backend=_port_backend(backend), **kw)
        want = jcostmodel.schedule_cost(schedule, m, n, k, algo=jax_rule,
                                        backend=_jax_backend(backend), **kw)
        for f in FIELDS:
            _assert_close(getattr(got, f), getattr(want, f))
        mach = costmodel.Machine(alpha=2e-6, beta=3e-10, gamma=1e-12)
        jmach = jcostmodel.Machine(alpha=2e-6, beta=3e-10, gamma=1e-12)
        _assert_close(got.time(mach), want.time(jmach))
        terms = costmodel.schedule_cost_terms(
            schedule, m, n, k, algo=port_rule,
            backend=_port_backend(backend), machine=mach, **kw)
        jterms = jcostmodel.schedule_cost_terms(
            schedule, m, n, k, algo=jax_rule,
            backend=_jax_backend(backend), machine=jmach, **kw)
        assert sorted(terms) == sorted(jterms)
        for key in terms:
            _assert_close(terms[key], jterms[key])


@pytest.mark.parametrize("spec", RULES, ids=lambda s: f"{s[0]}{s[1] or ''}")
def test_rule_cost_hooks_match_the_reference(spec):
    for (m, n, k, _), p in itertools.product(SHAPES, (1, 2, 4, 1024)):
        got, want = (_port_rule(spec).prepare_global(m, n, k),
                     _jax_rule(spec).prepare_global(m, n, k))
        for it in (1.0, 2.5):
            _assert_close(got.luc_flops(m / p, n / p, k, bpp_iters=it),
                          want.luc_flops(m / p, n / p, k, bpp_iters=it))
        for a, b in zip(got.extra_latency_words(k, p),
                        want.extra_latency_words(k, p)):
            _assert_close(a, b)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backend_cost_hooks_match_the_reference(backend):
    got, want = _port_backend(backend), _jax_backend(backend)
    from repro.backends import get_backend as jget
    from repro_torch.backends import get_backend
    got, want = get_backend(got), jget(want)
    for m, n, k, nnz in SHAPES:
        _assert_close(got.mm_flops(m, n, k, nnz=nnz),
                      want.mm_flops(m, n, k, nnz=nnz))
        _assert_close(got.storage_words(m, n, nnz=nnz),
                      want.storage_words(m, n, nnz=nnz))
        _assert_close(got.mm_traffic_words(m, n, k, nnz=nnz),
                      want.mm_traffic_words(m, n, k, nnz=nnz))


def test_grid_helpers_match_the_reference():
    from repro.core import costmodel as jcostmodel
    for (m, n, k, _), p in itertools.product(SHAPES, (1, 2, 6, 64, 1536)):
        assert costmodel.optimal_grid(m, n, p) == \
            jcostmodel.optimal_grid(m, n, p)
        _assert_close(costmodel.bandwidth_lower_bound_words(m, n, k, p),
                      jcostmodel.bandwidth_lower_bound_words(m, n, k, p))


# ---------------------------------------------------------------------------
# The reference's own cost-model tests, on the port
# ---------------------------------------------------------------------------

def test_optimal_grid_matches_paper_example():
    # Paper §6.3.4: 172,800 × 115,200 on p = 1536 -> 48 × 32
    assert costmodel.optimal_grid(172_800, 115_200, 1536) == (48, 32)
    assert costmodel.optimal_grid(10_000_000, 100, 64) == (64, 1)


def test_faun_beats_naive_at_scale():
    m, n, k = 207_360, 138_240, 50
    for p in [64, 256, 1024]:
        pr, pc = costmodel.optimal_grid(m, n, p)
        f = costmodel.mpifaun_cost(m, n, k, pr, pc)
        nv = costmodel.naive_cost(m, n, k, p)
        assert f.words < nv.words, (p, f.words, nv.words)
    pr, pc = costmodel.optimal_grid(m, n, 1024)
    f = costmodel.mpifaun_cost(m, n, k, pr, pc)
    assert f.words < 6 * costmodel.bandwidth_lower_bound_words(m, n, k, 1024)


def test_schedule_cost_threads_nnz():
    m, n, k, nnz = 100_000, 80_000, 32, 10_000_000
    dense = costmodel.schedule_cost("faun", m, n, k, pr=8, pc=8)
    sp = costmodel.schedule_cost("faun", m, n, k, pr=8, pc=8, dense=False,
                                 nnz=nnz)
    assert sp.flops < dense.flops and sp.memory_words < dense.memory_words
    assert sp.words == dense.words      # panels are dense either way
    serial = costmodel.schedule_cost("serial", m, n, k)
    assert serial.words == 0 and serial.messages == 0
    assert costmodel.schedule_cost("naive", m, n, k, pr=64).words \
        > dense.words                   # full-factor gathers


def test_serial_solver_predict_cost():
    c = NMFSolver(16, algo="mu", device="cpu").predict_cost(10_000, 8_000)
    assert c.flops > 0 and c.words == 0
    terms = NMFSolver(16, algo="mu", device="cpu").predict_cost_terms(
        10_000, 8_000)
    assert terms["comm"] == 0 and terms["mm"] > 0


def test_predict_cost_reflects_compression_closed_forms():
    m, n, k, pr, pc = 4096, 2048, 32, 4, 2
    p = pr * pc
    ex = costmodel.schedule_cost("faun", m, n, k, pr=pr, pc=pc, algo="mu")
    co = costmodel.schedule_cost("faun", m, n, k, pr=pr, pc=pc, algo="mu",
                                 compression="int8")
    panel_h, panel_w = (pr - 1) * n * k / p, (pc - 1) * m * k / p
    expect = (2 * 2 * k * k * (p - 1) / p + 2 * 2 * k * (p - 1) / p
              + compressed_words(panel_h, rows=(pr - 1) * n / p)
              + compressed_words(panel_w, rows=(pc - 1) * m / p)
              + compressed_words(panel_w, rows=(pc - 1) * m / p,
                                 scatter=True)
              + compressed_words(panel_h, rows=(pr - 1) * n / p,
                                 scatter=True))
    assert co.words == expect and co.words < ex.words
    assert co.messages == 2 * ex.messages and co.flops == ex.flops
    nex = costmodel.schedule_cost("naive", m, n, k, pr=p, algo="mu")
    nco = costmodel.schedule_cost("naive", m, n, k, pr=p, algo="mu",
                                  compression="int8")
    assert nco.words == nex.words / 4 + (m + n) * (p - 1) / p


def test_luc_flops_per_rule():
    m, n, k = 10_000, 8_000, 16
    base = costmodel.luc_flops("mu", m, n, k)
    assert base == 2.0 * (m + n) * k * k
    assert costmodel.luc_flops("hals", m, n, k) == base
    assert costmodel.luc_flops(rules.AcceleratedMURule(inner_iters=4),
                               m, n, k) == 4 * base
    assert costmodel.luc_flops("ahals", m, n, k) == \
        rules.get_rule("ahals").inner_iters * base
    assert costmodel.luc_flops("bpp", m, n, k) == \
        costmodel.luc_flops("abpp", m, n, k) > base


def test_accelerated_cost_honest_when_stall_exit_is_dead():
    m, n, k, pr, pc = 100_000, 80_000, 32, 2, 2
    mu = costmodel.schedule_cost("faun", m, n, k, pr=pr, pc=pc, algo="mu")
    one = costmodel.schedule_cost(
        "faun", m, n, k, pr=pr, pc=pc,
        algo=rules.AcceleratedMURule(inner_iters=1))
    assert one.messages == mu.messages and one.words == mu.words
    pinned = costmodel.schedule_cost(
        "faun", m, n, k, pr=pr, pc=pc,
        algo=rules.AcceleratedMURule(inner_iters=4, delta=0.0))
    assert pinned.messages == mu.messages
    live = costmodel.schedule_cost(
        "faun", m, n, k, pr=pr, pc=pc,
        algo=rules.AcceleratedMURule(inner_iters=4, delta=0.01))
    assert live.messages > mu.messages


def test_algorithms_module():
    assert set(algorithms.ALGORITHMS) == {"mu", "hals", "bpp"}
    G = torch.eye(3) * 2.0
    R = torch.ones((4, 3))
    fold = algorithms.make_fold_in("bpp", max_iter=5)
    np.testing.assert_allclose(fold(G, R).numpy(), 0.5)
    update_w, update_h = algorithms.get_update_fns("hals")
    X = torch.full((4, 3), 0.3)
    assert update_w(G, R, X).shape == (4, 3)
    np.testing.assert_allclose(update_h(G, R, X).numpy(), 0.5)
    calls = []

    class TracingBPP(rules.BPPRule):
        name = "tracingbpp"

        def fold_in(self, G, R, X0=None, *, iters=100):
            calls.append("fold")
            return super().fold_in(G, R, X0, iters=iters)

    algorithms.make_fold_in(TracingBPP(), max_iter=3)(G, R)
    assert calls == ["fold"]


def test_lower_step_is_refused_and_names_its_item():
    """lower_step is ported (item 12c): the solver's counts one step
    (``roofline.counts.StepRecord``), and the schedules' module functions
    take the reference's arguments, the layout first."""
    import inspect
    from repro_torch.core import faun, gspmd, naive
    from repro_torch.roofline.counts import StepRecord
    rec = NMFSolver(4, device="cpu").lower_step(32, 24)
    assert isinstance(rec, StepRecord) and "aten::mm" in rec.as_text()
    for fn, layout, algo in ((faun.lower_step, "grid", "bpp"),
                             (naive.lower_step, "group", "bpp"),
                             (gspmd.lower_step, "grid", "mu")):
        params = inspect.signature(fn).parameters
        assert list(params)[:4] == [layout, "m", "n", "k"]
        assert params["algo"].default == algo
        assert params["backend"].default == "dense"


# ---------------------------------------------------------------------------
# predict_cost on a grid
# ---------------------------------------------------------------------------

PREDICT = [("faun", "mu", None), ("faun", "hals", "int8"),
           ("naive", "bpp", None), ("naive", "mu", "int8"),
           ("gspmd", "mu", None)]


def _predict_rank(out):
    from repro_torch.core.faun import make_faun_grid
    grid = make_faun_grid(2, 2)
    rows = {}
    for schedule, algo, comp in PREDICT:
        kw = dict(grid=grid) if schedule != "naive" else {}
        for backend in ("dense", "sparse"):
            s = NMFSolver(32, algo=algo, schedule=schedule, backend=backend,
                          panel_compression=comp, device="cpu", **kw)
            c = s.predict_cost(4096, 2048, nnz=50_000.0, bpp_iters=2.0)
            rows[f"{schedule}_{algo}_{comp}_{backend}"] = (
                [getattr(c, f) for f in FIELDS],
                s.predict_cost_terms(4096, 2048, nnz=50_000.0),
                s._schedule.grid_shape)
    if dist.get_rank() == 0:
        np.save(os.path.join(out, "predict.npy"), rows)


@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("costmodel"))
    rdist.spawn(_predict_rank, 4, out, backend="gloo", device="cpu")
    return np.load(os.path.join(out, "predict.npy"), allow_pickle=True)[()]


@pytest.mark.parametrize("case", PREDICT, ids=lambda c: "_".join(map(str, c)))
def test_predict_cost_reads_the_grid(predicted, case):
    from repro.core import costmodel as jcostmodel
    schedule, algo, comp = case
    for backend in ("dense", "sparse"):
        fields, terms, shape = predicted[f"{schedule}_{algo}_{comp}_"
                                         f"{backend}"]
        pr, pc = (2, 2) if schedule != "naive" else (4, 1)
        assert tuple(shape) == (pr, pc)
        kw = dict(pr=pr, pc=pc, algo=algo, backend=backend, nnz=50_000.0,
                  compression=comp)
        want = jcostmodel.schedule_cost(schedule, 4096, 2048, 32,
                                        bpp_iters=2.0, **kw)
        for got, f in zip(fields, FIELDS):
            _assert_close(got, getattr(want, f))
        jterms = jcostmodel.schedule_cost_terms(schedule, 4096, 2048, 32,
                                                **kw)
        for key in jterms:
            _assert_close(terms[key], jterms[key])
