"""The port's compressed fits (``panel_compression="int8"``) against the JAX
package's compressed fits: ``faun`` on 1×1, 2×2 and the multi-pod grid
(JAX ("pod", "pr", "pc") = 2×2×1, the port's ``pods=2``), ``naive`` on
p = 1, 2, 4; mu, hals and bpp; the port's ``cuda`` (CPU path) and
``dense`` backends against JAX's ``dense``, its sparse ``scatter`` and
``sorted`` against JAX's ``sparse``.  The same numpy A and W0/H0 on both
sides.

Two comparisons:

* **step by step** (teacher forcing): for each iteration t the port runs
  one iteration from the JAX fit's state after t − 1 — W, H and this
  rank's slice of the JAX residuals — and lands on the JAX state after t.
  The two packages' fp32 sums differ by an ulp, and where that straddles
  a rounding boundary of the quantiser a decision flips: one panel entry
  moves by a quantisation step, and whatever is computed from it moves
  with it (on the multi-pod grid's first bpp step one flipped entry of
  rank 2's gathered W, in column 3, moves column 3 of its reduce-scatter
  residual, 64 entries by 0.07–0.11 of a step, and 37 of H's 384
  entries, by up to 5.2e-2 scaled: BPP's active sets amplify it).
  So W and H are held within a scaled 1e-3 (mu, hals; the largest gap
  read is 9.6e-5), bpp's W within 1e-4 (read 6.2e-6) and its H within
  1e-1; the rel
  error within 5e-5 (mu, hals; read 4.1e-6) and 1e-3 (bpp; read
  1.3e-4); every reduce-scatter and gather residual entry, measured in
  its own quantisation step, within 1e-2 of a step of JAX's (read 5.1e-3)
  or a flip — one step off, where JAX's entry lay within 1e-2 of a step
  of a rounding boundary — or, in a reduce-scatter residual, in a column
  where the gather feeding its product flipped (the multi-pod bpp
  entries above); each Gram residual (the Gram's own fp32 rounding at
  2²³ levels) within two quantisation steps.
* **whole fits** of ``ITERS`` iterations from the same start.  Flips
  compound, and the hals and bpp trajectories part: the JAX package's own
  ``dense`` and ``pallas`` backends part as far
  (``tools/probe_compressed_fits.py``, PERF.md §6).  So mu is held over
  the whole fit (W, H scaled 1e-5, rel errors 2e-5; read 1.1e-6 and
  2.1e-6), hals and bpp over their first iteration's rel error (1e-3) and
  their rel errors over the whole fit within 1e-2 (read 5.1e-3).

The JAX side runs this file as a script in a fresh interpreter with 4
forced host devices, before the port's ranks (which read its states) are
spawned, once per group size (``util.dist.spawn``).  No module a rank
imports imports JAX at its top.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.backends import SparseOps
from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
ITERS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = ("mu", "hals", "bpp")
# JAX runs: (tag, schedule, layout, algo, JAX backend); layout is the faun
# grid ("1x1", "2x2", "pods") or naive's p
JAX_RUNS = ([(f"faun_{g}_{a}", "faun", g, a, "dense")
             for g in ("1x1", "2x2", "pods") for a in ALGOS]
            + [(f"faun_2x2_{a}_sparse", "faun", "2x2", a, "sparse")
               for a in ALGOS]
            + [(f"naive_{p}_{a}", "naive", p, a, "dense")
               for p in (1, 2, 4) for a in ALGOS]
            + [("naive_4_mu_sparse", "naive", 4, "mu", "sparse")])
# the port's runs against them: (tag, JAX tag, port backend)
CASES = ([(f"{t}_{b}", t, b) for t, s, g, a, jb in JAX_RUNS if jb == "dense"
          for b in (("cuda",) if g == "pods" else ("cuda", "dense"))]
         + [(f"{t}_{b}", t, b) for t, s, g, a, jb in JAX_RUNS
            if jb == "sparse" for b in ("scatter", "sorted")])
RUN = {t: (s, g, a) for t, s, g, a, _ in JAX_RUNS}
RANKS = {"1x1": 1, "2x2": 4, "pods": 4, 1: 1, 2: 2, 4: 4}
# a panel residual entry's gap, in its own quantisation steps: within this
# of JAX's, or a flip (one step off) of an entry JAX left within this of a
# rounding boundary
RES_STEP_TOL = 1e-2
# per-step tolerances: (W, H, rel) by rule
STEP_TOL = {"mu": (1e-3, 1e-3, 5e-5), "hals": (1e-3, 1e-3, 5e-5),
            "bpp": (1e-4, 1e-1, 1e-3)}


def _problem(seed=0, m=M, n=N, k=K, noise=0.5):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + noise * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0


# ---------------------------------------------------------------------------
# The JAX side (run as a script)
# ---------------------------------------------------------------------------

def _jax_main(out):
    """Each JAX run's state after every iteration: W, Hᵀ, the rel error
    and the stacked residuals."""
    from repro.util import env
    env.configure(host_device_count=4)        # before any jax import
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import faun
    from repro.core.engine import NMFSolver as JaxSolver
    devs = np.asarray(jax.devices()[:4])
    grids = {"1x1": faun.make_faun_mesh(1, 1),
             "2x2": faun.make_faun_mesh(2, 2),
             "pods": faun.FaunGrid(mesh=Mesh(devs.reshape(2, 2, 1),
                                             ("pod", "pr", "pc")),
                                   row_axes=("pod", "pr"), col_axis="pc")}
    A, W0, H0 = (jnp.asarray(x) for x in _problem())
    for tag, schedule, layout, algo, backend in JAX_RUNS:
        kw = (dict(grid=grids[layout]) if schedule == "faun"
              else dict(mesh=Mesh(devs[:layout], ("p",))))
        solver = JaxSolver(K, algo=algo, schedule=schedule, backend=backend,
                           panel_compression="int8", max_iters=ITERS, **kw)
        rs = solver.prepare_state(A, W0=W0, H0=H0)
        rows = {}
        for t in range(ITERS + 1):
            if t:
                solver.run_segment(rs, 1)
                rows[f"rel{t}"] = np.asarray(rs.rel_history[-1])[0]
            rows[f"W{t}"] = np.asarray(rs.W)
            rows[f"Ht{t}"] = np.asarray(rs.Ht)
            _, res = solver._schedule.split_state(rs.state)
            for key, v in res.items():
                rows[f"res_{key}{t}"] = np.asarray(v)
        np.savez(os.path.join(out, f"jax_{tag}.npz"), **rows)


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------

def _cell(layout, grid_or_rank):
    """Index of this rank's slice of a JAX residual leaf."""
    if layout in ("1x1", "2x2"):
        return (grid_or_rank.i, grid_or_rank.j)
    if layout == "pods":                      # (pod, pr, pc), pr = 2
        return (grid_or_rank.i // 2, grid_or_rank.i % 2, grid_or_rank.j)
    return (grid_or_rank,)


def _save(path, res, steps=None):
    rows = {"W": res.W.numpy(), "H": res.H.numpy(),
            "rels": res.rel_errors.numpy()}
    rows.update({f"res_{key}": v.numpy()
                 for key, v in res.extras["panel_residuals"].items()})
    rows.update({f"step_{key}": v.numpy()
                 for key, v in (steps or {}).items()})
    np.savez(path, **rows)


def _record_steps(compress, res):
    """Record, under each residual's key, the quantisation step of every
    entry (the fused scale the quantiser divided by) in ``steps``."""
    steps, quantize = {}, compress._ef_quantize

    def recording(x, residual, **kwargs):
        q, rs, cs, new = quantize(x, residual, **kwargs)
        key, = [k for k, v in res.items() if v is residual]
        steps[key] = torch.clamp_min(rs[:, None] * cs[None, :],
                                     torch.finfo(torch.float32).tiny)
        return q, rs, cs, new

    compress._ef_quantize = recording
    return steps


def _rank(out, p):
    A, W0, H0 = _problem()
    rank = dist.get_rank()
    grids = {}
    if p == 1:
        grids["1x1"] = make_faun_grid(1, 1)
    if p == 4:
        grids["2x2"] = make_faun_grid(2, 2)
        grids["pods"] = make_faun_grid(2, 1, pods=2)
    for tag, jtag, backend in CASES:
        schedule, layout, algo = RUN[jtag]
        if RANKS[layout] != p:
            continue
        ops = (SparseOps(spmm_impl=backend)
               if backend in ("scatter", "sorted") else backend)
        kw = dict(algo=algo, schedule=schedule, backend=ops, device="cpu",
                  panel_compression="int8")
        if schedule == "faun":
            kw["grid"] = grids[layout]
        cell = _cell(layout, grids.get(layout, rank))
        _save(os.path.join(out, f"port_{tag}_r{rank}.npz"),
              NMFSolver(K, max_iters=ITERS, **kw).fit(A, W0=W0, H0=H0))
        with np.load(os.path.join(out, f"jax_{jtag}.npz")) as z:
            want = {key: z[key] for key in z.files}
        for t in range(1, ITERS + 1):
            solver = NMFSolver(K, max_iters=1, **kw)
            rs = solver.prepare_state(A, W0=want[f"W{t - 1}"],
                                      H0=want[f"Ht{t - 1}"].T)
            res = {key[4:-1]: torch.from_numpy(v[cell].copy())
                   for key, v in want.items()
                   if key.startswith("res_") and key.endswith(str(t - 1))}
            rs.state = (rs.state[0], res)
            steps = _record_steps(solver.compress, res)
            solver.run_segment(rs, 1)
            _save(os.path.join(out, f"step_{tag}_t{t}_r{rank}.npz"),
                  solver.collect_result(rs), steps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("compression_parity"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jax_run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              out], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=600)
    assert jax_run.returncode == 0, jax_run.stdout
    for p in (1, 2, 4):
        rdist.spawn(_rank, p, out, p, backend="gloo", device="cpu")
    return out


def _load(path):
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def scaled(got, want) -> float:
    """max |got − want| / max |want|."""
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def residual_gaps(got, want):
    """The largest |got − want| of a Gram residual in quantisation steps.
    A residual lies within half a step of zero, so one step is 2·max|want|
    (at most); the Gram's own fp32 rounding is a step or two at 2²³
    levels."""
    top = float(np.abs(want).max()) + 1e-30
    return float(np.abs(got - want).max() / (2 * top))


def panel_residual_gaps(got, want, step, moved_cols=None):
    """(the largest gap of an entry that is neither a flip nor moved by
    one, the flips, the entries moved by an earlier flip, and the columns
    that flipped) of a panel residual, each entry measured in its own
    quantisation step ``step`` (the port's fused scale).  A flip is an
    entry one step off (within ``RES_STEP_TOL``) whose JAX residual lay
    within ``RES_STEP_TOL`` of a rounding boundary (half a step): the
    ulp-straddle explained in the module docstring.  A flipped entry of a
    gathered panel's column c moves column c of the product it feeds,
    and nothing else: ``moved_cols`` marks those columns of a
    reduce-scatter residual, whose entries there may differ.  Any other
    entry must agree within ``RES_STEP_TOL`` steps."""
    gap = np.abs(got - want) / step
    flip = ((np.abs(gap - 1.0) <= RES_STEP_TOL)
            & (0.5 - np.abs(want) / step <= RES_STEP_TOL))
    moved = np.zeros_like(flip)
    if moved_cols is not None:
        moved[:, moved_cols] = (gap > RES_STEP_TOL)[:, moved_cols] & ~flip[
            :, moved_cols]
    rest = gap[~flip & ~moved]
    return ((float(rest.max()) if rest.size else 0.0), int(flip.sum()),
            int(moved.sum()), flip.any(axis=0))


#: each reduce-scatter residual and the gather that feeds its product in
#: the same half-iteration
_FED_BY = {"rs_w": "gather_h", "rs_h": "gather_w"}


def gaps(out, tag, jtag):
    """Every gap the tests hold, for ``tools/`` to print: {"step": [(t, W,
    H, rel, the largest Gram-residual gap in steps, the largest gap of a
    panel-residual entry that is neither a flip nor moved by one, in its
    steps, the flips and the entries they moved, over all ranks)], "fit":
    (W, H, the largest rel-error gap, the first iteration's)}."""
    schedule, layout, algo = RUN[jtag]
    want = _load(os.path.join(out, f"jax_{jtag}.npz"))
    step_rows = []
    for t in range(1, ITERS + 1):
        ranks = []
        for r in range(RANKS[layout]):
            cell = _cell(layout, _Cell(r, layout)
                         if isinstance(layout, str) else r)
            got = _load(os.path.join(out, f"step_{tag}_t{t}_r{r}.npz"))
            ranks.append((got, {key: want[f"{key}{t}"][cell]
                                for key in got if key.startswith("res_")}))
        gram_steps, panel_steps, flips, moved = 0.0, 0.0, 0, 0
        flipped = {}            # a gather's flipped columns, on any rank
        for key in ("gather_h", "gather_w", "rs_w", "rs_h"):
            for got, w in ranks:
                if f"res_{key}" not in got:
                    continue
                worst, n, n_moved, cols = panel_residual_gaps(
                    got[f"res_{key}"], w[f"res_{key}"], got[f"step_{key}"],
                    flipped.get(_FED_BY.get(key)))
                flipped[key] = flipped.get(key, False) | cols
                panel_steps = max(panel_steps, worst)
                flips, moved = flips + n, moved + n_moved
        for got, w in ranks:
            for key in ("res_gram_w", "res_gram_h"):
                if key in got:
                    gram_steps = max(gram_steps,
                                     residual_gaps(got[key], w[key]))
        got = ranks[0][0]
        step_rows.append((t, scaled(got["W"], want[f"W{t}"]),
                          scaled(got["H"], want[f"Ht{t}"].T),
                          abs(float(got["rels"][0]) - float(want[f"rel{t}"])),
                          gram_steps, panel_steps, flips, moved))
    fit = _load(os.path.join(out, f"port_{tag}_r0.npz"))
    rels = np.array([want[f"rel{t}"] for t in range(1, ITERS + 1)])
    fit_row = (scaled(fit["W"], want[f"W{ITERS}"]),
               scaled(fit["H"], want[f"Ht{ITERS}"].T),
               float(np.abs(fit["rels"] - rels).max()),
               abs(float(fit["rels"][0]) - float(rels[0])))
    return {"step": step_rows, "fit": fit_row}


class _Cell:
    """A grid cell (i, j) from a rank, for ``_cell`` outside the ranks."""

    def __init__(self, rank, layout):
        pc = 2 if layout == "2x2" else 1
        self.i, self.j = divmod(rank, pc)


def _first_iteration(out, tag):
    """The whole fit's first iteration: the step from the shared start."""
    return _load(os.path.join(out, f"step_{tag}_t1_r0.npz"))


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_each_compressed_iteration_matches_jax(runs, case):
    tag, jtag, _ = case
    w_tol, h_tol, rel_tol = STEP_TOL[RUN[jtag][2]]
    for t, w, h, rel, gram_steps, panel_steps, flips, moved in gaps(
            runs, tag, jtag)["step"]:
        assert w <= w_tol and h <= h_tol, (t, w, h)
        assert rel <= rel_tol, (t, rel)
        assert gram_steps <= 2.0, (t, gram_steps)
        assert panel_steps <= RES_STEP_TOL, (t, panel_steps, flips, moved)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_compressed_fit_matches_jax(runs, case):
    tag, jtag, _ = case
    algo = RUN[jtag][2]
    w, h, rels, first = gaps(runs, tag, jtag)["fit"]
    if algo == "mu":
        assert w <= 1e-5 and h <= 1e-5, (w, h)
        assert rels <= 2e-5, rels
    else:
        assert first <= 1e-3, first
        assert rels <= 1e-2, rels


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_every_rank_holds_the_same_compressed_fit(runs, case):
    tag, jtag, _ = case
    layout = RUN[jtag][1]
    want = _load(os.path.join(runs, f"port_{tag}_r0.npz"))
    for r in range(1, RANKS[layout]):
        got = _load(os.path.join(runs, f"port_{tag}_r{r}.npz"))
        for key in ("W", "H", "rels"):
            np.testing.assert_array_equal(got[key], want[key])
        for key in got:
            if key.startswith("res_"):
                assert got[key].shape == want[key].shape


if __name__ == "__main__":
    _jax_main(sys.argv[1])
