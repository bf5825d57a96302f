"""Phase-level iteration profiling: measure what the cost model predicts.
Counterpart of ``repro/obs/phases.py``.

The paper's headline evidence (Figs 7–9) splits each iteration into local
computation (Gram, MM, NLS) against communication (all-gathers,
reduce-scatters); ``core/costmodel.py`` predicts those terms.
``NMFSolver.fit(profile=True)`` routes here and runs the SAME iteration as
a **host-driven chain of per-phase segments**, each one the schedule's own
backend, rule and collective calls for one phase of the algorithm, with
the device synchronised at every segment boundary, so the host clock
between two boundaries measures exactly one phase.  The reference compiles
one segment per phase for the same reason; eager PyTorch needs no
compilation, so a segment is a plain call.

Phase keys per schedule (the six collectives of Algorithm 3 are each their
own phase on faun; naive has only its two factor gathers; gspmd's
collectives are DTensor's, inside the compute segments):

    serial  gram_w mm_w luc_w gram_h mm_h luc_h error
    faun    gram_w allreduce_gram_w allgather_h mm_w reduce_scatter_w
            luc_w gram_h allreduce_gram_h allgather_w mm_h
            reduce_scatter_h luc_h error
    naive   allgather_h gram_w mm_w luc_w allgather_w gram_h mm_h luc_h
            error
    gspmd   gram_w mm_w luc_w gram_h mm_h luc_h error

The segments launch exactly the kernels of the unprofiled loop, through
the same calls on the same operands in the same order, so a profiled fit
gives the unprofiled fit's bits (factors, rel errors, stopping).  The
numbers land in ``NMFResult.extras["phase_times"]`` (mean seconds per
iteration per phase); one untimed pass from the initial factors runs first
and is discarded (the reference's compile pass: here it warms the kernel
build and the communicators), so the means are steady state.

Splitting an iteration at phase boundaries adds a synchronisation per
phase, so a profiled run is a little slower than the production loop: this
is a measurement mode.  ``profile=True`` refuses the wire-format knobs
``panel_dtype`` and ``panel_compression``, as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

#: phase key -> cost-model group (the report's join key)
PHASE_GROUPS = {
    "gram": "gram", "mm": "mm", "luc": "luc", "error": "error",
    "allreduce": "comm", "allgather": "comm", "reduce_scatter": "comm",
}


def phase_group(phase: str) -> str:
    """Map a measured phase key to its cost-model group
    (gram / mm / luc / comm / error)."""
    for prefix, group in PHASE_GROUPS.items():
        if phase.startswith(prefix):
            return group
    return "other"


def expected_phases(schedule: str) -> tuple[str, ...]:
    """The phase keys ``fit(profile=True)`` reports for a schedule."""
    compute = ("gram_{h}", "mm_{h}", "luc_{h}")
    if schedule == "faun":
        half = ("gram_{h}", "allreduce_gram_{h}", "allgather_{o}",
                "mm_{h}", "reduce_scatter_{h}", "luc_{h}")
    elif schedule == "naive":
        half = ("allgather_{o}",) + compute
    elif schedule in ("serial", "gspmd"):
        half = compute
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    out = []
    for h, o in (("w", "h"), ("h", "w")):
        out += [p.format(h=h, o=o) for p in half]
    return tuple(out) + ("error",)


class _Segment:
    """One phase: ``fn(*env[in_keys]) -> env[out_keys]``."""

    __slots__ = ("phase", "fn", "in_keys", "out_keys")

    def __init__(self, phase, fn, in_keys, out_keys):
        self.phase, self.fn = phase, fn
        self.in_keys, self.out_keys = in_keys, out_keys


def _luc(update, norm_psum=None):
    """A rule half-update as a segment; ``norm_psum`` None: serial, every
    row on this device."""
    return lambda G, R, X, state: update(G, R, X, state, norm_psum=norm_psum)


# ---------------------------------------------------------------------------
# Per-schedule segment builders: each phase the schedule's own call, in the
# order the schedule's step makes them (core/aunmf.py, core/faun.py,
# core/naive.py, core/gspmd.py).
# ---------------------------------------------------------------------------

def _serial_segments(sched) -> list[_Segment]:
    from repro_torch.core.error import sq_error_from_products
    ops, rule = sched.s.ops, sched.s.rule
    S = _Segment

    def err(normA, WtAt, Ht, WtW):
        return sq_error_from_products(normA, WtAt, Ht, WtW, ops.gram(Ht))

    return [
        S("gram_w", ops.gram, ("Ht",), ("HHt",)),
        S("mm_w", ops.mm, ("A", "Ht"), ("AHt",)),
        S("luc_w", _luc(rule.update_w), ("HHt", "AHt", "W", "state"),
          ("W", "state")),
        S("gram_h", ops.gram, ("W",), ("WtW",)),
        S("mm_h", ops.mm_t, ("A", "W"), ("WtAt",)),
        S("luc_h", _luc(rule.update_h), ("WtW", "WtAt", "Ht", "state"),
          ("Ht", "state")),
        S("error", err, ("normA", "WtAt", "Ht", "WtW"), ("sq",)),
    ]


def _dist_error(ops, group):
    """faun's and naive's error from byproducts: the new Hᵀ's Gram and the
    cross term all-reduced over ``group``."""
    from repro_torch.core.faun import all_reduce, gram_allreduce

    def err(normA, WtAt, Ht, WtW):
        HHt_new = gram_allreduce(Ht, group, gram=ops.gram)
        cross = all_reduce((WtAt.float() * Ht.float()).sum(), group)
        quad = (WtW.float() * HHt_new.float()).sum()
        return normA - 2.0 * cross + quad
    return err


def _faun_segments(sched) -> list[_Segment]:
    import torch.distributed as dist
    from repro_torch.core.faun import (all_reduce, allgather_panel,
                                       matmul_reducescatter)
    g, ops, rule = sched.grid, sched.s.ops, sched.s.rule
    world, row_g, col_g = g.world, g.row_group, g.col_group
    S = _Segment

    def allreduce(x):
        dist.all_reduce(x, group=world)
        return x

    def norm_psum(v):
        return all_reduce(v, world)

    return [
        # ---- W half (paper lines 3–8), one segment per phase ----
        S("gram_w", ops.gram, ("Ht",), ("Ugw",)),
        S("allreduce_gram_w", allreduce, ("Ugw",), ("HHt",)),
        S("allgather_h", lambda x: allgather_panel(x, col_g), ("Ht",),
          ("Hp",)),
        S("mm_w", ops.mm, ("A", "Hp"), ("V",)),
        S("reduce_scatter_w", lambda x: matmul_reducescatter(x, row_g),
          ("V",), ("AHt",)),
        S("luc_w", _luc(rule.update_w, norm_psum),
          ("HHt", "AHt", "W", "state"), ("W", "state")),
        # ---- H half (lines 9–14, pr ↔ pc) ----
        S("gram_h", ops.gram, ("W",), ("Ugh",)),
        S("allreduce_gram_h", allreduce, ("Ugh",), ("WtW",)),
        S("allgather_w", lambda x: allgather_panel(x, row_g), ("W",),
          ("Wp",)),
        S("mm_h", ops.mm_t, ("A", "Wp"), ("Y",)),
        S("reduce_scatter_h", lambda x: matmul_reducescatter(x, col_g),
          ("Y",), ("WtAt",)),
        S("luc_h", _luc(rule.update_h, norm_psum),
          ("WtW", "WtAt", "Ht", "state"), ("Ht", "state")),
        S("error", _dist_error(ops, world), ("normA", "WtAt", "Ht", "WtW"),
          ("sq",)),
    ]


def _naive_segments(sched) -> list[_Segment]:
    from repro_torch.core.faun import all_reduce, allgather_panel
    group, ops, rule = sched.group, sched.s.ops, sched.s.rule
    S = _Segment

    def norm_psum(v):
        return all_reduce(v, group)

    def gather(x):
        return allgather_panel(x, group)

    return [
        # the redundant per-rank Grams of Algorithm 2: every rank forms the
        # whole k×k from its gathered copy
        S("allgather_h", gather, ("Ht",), ("Hf",)),
        S("gram_w", ops.gram, ("Hf",), ("HHt",)),
        S("mm_w", ops.mm, ("Arow", "Hf"), ("AHt",)),
        S("luc_w", _luc(rule.update_w, norm_psum),
          ("HHt", "AHt", "W", "state"), ("W", "state")),
        S("allgather_w", gather, ("W",), ("Wf",)),
        S("gram_h", ops.gram, ("Wf",), ("WtW",)),
        S("mm_h", ops.mm_t, ("Acol", "Wf"), ("WtAt",)),
        S("luc_h", _luc(rule.update_h, norm_psum),
          ("WtW", "WtAt", "Ht", "state"), ("Ht", "state")),
        S("error", _dist_error(ops, group), ("normA", "WtAt", "Ht", "WtW"),
          ("sq",)),
    ]


def _gspmd_segments(sched) -> list[_Segment]:
    # A global-view program has no explicit collective to segment: DTensor
    # inserts its redistributions inside each compute segment, so their
    # cost lands in the phase whose product forced them.
    from repro_torch.core.error import sq_error_from_products
    from repro_torch.core.gspmd import _whole, rule_on_rows
    ops, rule = sched.ops, sched.s.rule
    S = _Segment

    def luc(update):
        return lambda G, R, X, state: rule_on_rows(update, G, R, X, state)

    def err(normA, WtAt, Ht, WtW):
        return _whole(sq_error_from_products(normA, WtAt, Ht, WtW,
                                             ops.gram(Ht)))

    return [
        S("gram_w", ops.gram, ("Ht",), ("HHt",)),
        S("mm_w", ops.mm, ("A", "Ht"), ("AHt",)),
        S("luc_w", luc(rule.update_w), ("HHt", "AHt", "W", "state"),
          ("W", "state")),
        S("gram_h", ops.gram, ("W",), ("WtW",)),
        S("mm_h", ops.mm_t, ("A", "W"), ("WtAt",)),
        S("luc_h", luc(rule.update_h), ("WtW", "WtAt", "Ht", "state"),
          ("Ht", "state")),
        S("error", err, ("normA", "WtAt", "Ht", "WtW"), ("sq",)),
    ]


_BUILDERS = {"serial": _serial_segments, "faun": _faun_segments,
             "naive": _naive_segments, "gspmd": _gspmd_segments}


def _init_env(sched, rs) -> dict:
    env = {"W": rs.W, "Ht": rs.Ht, "normA": rs.normA_sq, "state": rs.state}
    if sched.name == "naive":
        env["Arow"], env["Acol"] = rs.A
    else:
        env["A"] = rs.A
    return env


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_chain(segs, env, device, times=None, tracer=None,
               iteration=0) -> dict:
    """One iteration: every segment in turn, the device synchronised at
    each boundary, into ``env``; the carry dtype restored at the end, as
    the engine's step does (backends emit fp32 from low-precision
    factors)."""
    dtypes = env["W"].dtype, env["Ht"].dtype
    for seg in segs:
        t0 = time.perf_counter()
        out = seg.fn(*(env[k] for k in seg.in_keys))
        _synchronize(device)
        t1 = time.perf_counter()
        if len(seg.out_keys) == 1:
            out = (out,)
        env.update(zip(seg.out_keys, out))
        if times is not None:
            times[seg.phase] = times.get(seg.phase, 0.0) + (t1 - t0)
        if tracer is not None:
            tracer.record(f"phase.{seg.phase}", t0, t1,
                          (("iteration", iteration),))
    env["W"], env["Ht"] = env["W"].to(dtypes[0]), env["Ht"].to(dtypes[1])
    return env


def run_profiled(solver, rs, tracer=None) -> dict[str, float]:
    """Advance the prepared run ``rs`` (``NMFSolver.prepare_state``) through
    the profiled loop, in place, with the solver's stopping criterion (the
    engine's stopping test, on the engine's rel errors); returns the mean
    seconds per iteration of each phase.

    The first pass over the chain runs from the initial factors with its
    outputs and timings discarded, then the timed loop starts from the
    same inputs: the segments never write their inputs, so the warm-up
    costs one iteration and changes no bit.
    """
    from repro_torch.core.engine import _rel_error, _stopping_test
    sched, crit, device = solver._schedule, solver.stopping, solver.device
    segs = _BUILDERS[sched.name](sched)
    env = _init_env(sched, rs)
    _synchronize(device)
    _run_chain(segs, dict(env), device)            # warm-up: discarded

    done = _stopping_test(crit) if crit.adaptive else None
    times: dict[str, float] = {}
    rels = []
    for it in range(crit.max_iters):
        t_it = time.perf_counter()
        env = _run_chain(segs, env, device, times=times, tracer=tracer,
                         iteration=it)
        if tracer is not None:
            tracer.record("phase.iteration", t_it, time.perf_counter(),
                          (("iteration", it),))
        rel = _rel_error(env["sq"], rs.normA_sq)
        if done is None:
            rels.append(rel)
            continue
        rels.append(np.float32(rel.item()))
        if done(rels[-1]):
            break
    rs.W, rs.Ht, rs.state = env["W"], env["Ht"], env["state"]
    if not rels:
        return {}
    rs.step += len(rels)
    rs.rel_history.append(torch.stack(rels).cpu() if done is None
                          else torch.tensor(rels, dtype=torch.float32))
    return {k: v / len(rels) for k, v in times.items()}
