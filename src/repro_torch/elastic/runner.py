"""ElasticRunner: checkpointed segmented training that survives death — the
counterpart of ``repro/elastic/runner.py``.

``NMFSolver.fit`` runs a whole factorization in one call: a crash at
iteration 199/200 loses everything.  The runner slices the same run into
fixed-iteration segments through the engine's segment API
(``prepare_state`` / ``run_segment`` / ``collect_result``), snapshotting
the FULL resumable state at every boundary:

    W, H, rule state, panel-compression residuals, rel-error history,
    the global step, the init seed, and the solver's config fingerprint

via ``checkpoint.write_payload`` (atomic, checksummed) — asynchronously,
off the step path: the loop only blocks to copy the snapshot to the host
and join the PREVIOUS write.  Segments run the same step on the same state
as one fit, so a run killed at any boundary and resumed is
**bit-identical** to the uninterrupted run on the exact wire format (the
compressed-panel path restores its error-feedback residuals too, except
across a remesh — see ``repro_torch.elastic.remesh``).

The payload is the reference's, key for key: the arrays ``W``, ``H``,
``rel_errors``, ``rule::<path>`` (amu's sweep counters as int32 0-d
arrays) and ``res::<path>`` (the residuals in the reference's stacked
global layout: faun ``(pr, pc, rows, k)`` with pods folded into the grid's
rows, naive ``(p, rows, k)``, gspmd global-shaped), and a meta with step,
time, m, n, dtype, segment_iters and the fingerprint.  The port records
``seed`` in the meta where the reference stores a ``prng_key`` array, and
ignores a ``prng_key`` when it reads a JAX payload.  A bf16 factor is
written as float32 (exact: numpy has no bfloat16) and read back in the
problem's dtype.  So the JAX package's ``load_checkpoint`` and
``ElasticRunner`` resume what the port writes, and the reverse.

``fit`` auto-restores from the newest *valid* checkpoint: torn saves
(crash between ``write_payload``'s two renames) are repaired via
``recover_payload``, corrupt/truncated payloads (``CheckpointCorrupt``)
are skipped in favour of the previous step, and a config-fingerprint
mismatch refuses loudly (:class:`CheckpointMismatch`) — a run never
silently resumes under a different rank, algorithm, or regularisation.
The layout fields (schedule, backend, pr×pc grid) are NOT enforced: a
checkpoint taken on one grid resumes on another (``repro_torch.elastic.
remesh``).

On a grid (faun, naive, gspmd) every rank runs the runner with the same
arguments.  The factors and residuals are gathered as ``collect`` gathers
them; only rank 0 of the schedule's group writes (one write in flight);
rank 0 alone runs the restore scan, repairing and skipping as above, and
broadcasts the step it chose (or none), which every rank then reads — so
no two ranks repair a torn save, or resume from different steps.  A
``FaultPlan`` fires on every rank at the same step (the storage faults on
the writer only, the crash on all).

Deterministic chaos (``repro_torch.elastic.faults``) injects crashes, torn
saves, corruption, and bounded-retry transients at planned steps; every
decision emits through ``repro_torch.obs`` (counters, a checkpoint-overhead
histogram, trace spans, structured event-log lines), under the reference's
names.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as _ckpt
from repro_torch.core.engine import NMFSolver, RunState
from repro_torch.elastic.faults import (FaultPlan, InjectedFault,
                                        RetryPolicy, TransientFault)
from repro_torch.obs.log import get_logger, log_event
from repro_torch.obs.metrics import (LATENCY_BUCKETS_S, default_registry,
                                     next_instance_label)
from repro_torch.obs.trace import default_tracer

_log = get_logger("elastic.runner")
_SEP = "::"

#: Fingerprint fields a resume may never change (the rest — schedule,
#: backend, grid, compression — are provenance and free to differ).
ENFORCED_FINGERPRINT = ("k", "rule")


class CheckpointMismatch(RuntimeError):
    """The checkpoint was written by a solver with a different problem
    identity (rank k, update rule, or regularisation).  Resuming would
    silently optimise a different objective — refused.  Start a fresh
    ``ckpt_dir``, or construct a matching solver (layout fields like the
    pr×pc grid MAY differ; see ``repro_torch.elastic.remesh``)."""


def _flatten_keyed(tree, prefix: str) -> dict[str, np.ndarray]:
    """A nested container as host arrays under ``prefix`` + the
    ``::``-joined key paths of ``checkpoint._flatten``; a Python int leaf
    (amu's sweep counters) as an int32 0-d array, as the reference holds
    it."""
    flat = {}

    def leaf(path, x):
        if isinstance(x, (bool, int)):
            x = np.asarray(x, np.int32)
        flat[prefix + _SEP.join(path)] = _ckpt._as_numpy(x)

    _ckpt._map_leaves(tree, leaf)
    return flat


def _unflatten_keyed(template, arrays: dict, prefix: str):
    """``template``'s structure filled from prefixed arrays (as saved); None
    when a key is missing (the saved tree had another structure — e.g. a
    schedule change moved residual layouts)."""
    missing = []

    def leaf(path, _x):
        key = prefix + _SEP.join(path)
        if key not in arrays:
            missing.append(key)
            return None
        return arrays[key]

    out = _ckpt._map_leaves(template, leaf)
    return None if missing else out


def _candidate_steps(ckpt_dir: str) -> list[int]:
    """Checkpoint steps present on disk, newest first — including steps
    whose final dir is absent but recoverable from a torn-save
    ``.old_step_<N>_<pid>`` survivor."""
    steps = set()
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            steps.add(int(name.split("_")[1]))
        elif name.startswith(".old_step_"):
            steps.add(int(name.split("_")[2]))
    return sorted(steps, reverse=True)


def _host(x) -> np.ndarray:
    """A host copy of a factor that shares no memory with the run (the
    next segment may go on while the writer thread saves it)."""
    arr = _ckpt._as_numpy(x)
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        arr = arr.copy()
    return arr


def _dtype_name(dtype) -> str:
    """The reference's meta string of a dtype ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


class ElasticRunner:
    """Run ``solver.fit(A)`` in checkpointed segments.

    >>> runner = ElasticRunner(solver, ckpt_dir, segment_iters=10)
    >>> result = runner.fit(A)        # crash anywhere...
    >>> result = runner.fit(A)        # ...and this resumes, bit-identical

    ``segment_iters`` sets the boundary spacing (the crash-loss bound and
    the checkpoint-overhead knob); ``keep_last`` bounds disk.  Adaptive
    stopping criteria on the solver (tol / stall) are honoured at segment
    granularity: the segments stay fixed-length (that is what makes resume
    bit-exact) and the criterion is evaluated on the host between them.

    ``fault_plan`` (a ``repro_torch.elastic.faults.FaultPlan``) injects
    deterministic chaos; ``retry`` bounds transient-fault retries.  Saves
    are async (one write in flight, the loop blocks only on the host copy
    + the previous write) unless a fault plan needs the payload on disk
    synchronously.  All counters/histograms land in ``registry`` (default
    process registry) under a process-unique ``instance`` label.
    """

    def __init__(self, solver: NMFSolver, ckpt_dir: str, *,
                 segment_iters: int = 10, keep_last: int = 3,
                 fault_plan: FaultPlan | None = None,
                 retry: RetryPolicy | None = None,
                 registry=None, tracer=None, async_save: bool = True):
        if segment_iters <= 0:
            raise ValueError(f"segment_iters must be positive, got "
                             f"{segment_iters}")
        self.solver = solver
        self.ckpt_dir = ckpt_dir
        self.segment_iters = int(segment_iters)
        self.keep_last = int(keep_last)
        self.fault_plan = fault_plan
        self.retry = retry or RetryPolicy()
        self._tracer = tracer or default_tracer()
        self.async_save = async_save
        self._writer: threading.Thread | None = None
        self._write_error: Exception | None = None
        reg = registry or default_registry()
        labels = {"instance": next_instance_label()}
        c = lambda name, hlp: reg.counter(name, labels=labels, help=hlp)
        self.saves = c("elastic_saves_total",
                       "Segment checkpoints published")
        self.restores = c("elastic_restores_total",
                          "Runs resumed from a checkpoint")
        self.corrupt_payloads = c("elastic_corrupt_payloads_total",
                                  "Payloads skipped as corrupt/truncated")
        self.recovered_payloads = c("elastic_recovered_payloads_total",
                                    "Torn saves repaired from .old_ dirs")
        self.retries = c("elastic_retries_total",
                         "Segment retries after transient faults")
        self.residual_reinits = c(
            "elastic_residual_reinits_total",
            "Panel residuals re-zeroed on restore (remesh path)")
        self.ckpt_block_seconds = reg.histogram(
            "elastic_checkpoint_block_seconds", buckets=LATENCY_BUCKETS_S,
            labels=labels,
            help="Step-path blocking time per checkpoint (gather + join)")

    # -- the grid ------------------------------------------------------------

    @property
    def _distributed(self) -> bool:
        return self.solver._schedule.distributed

    def _is_writer(self) -> bool:
        """Rank 0 of the schedule's group (the only rank that writes and
        scans); every rank of a serial solver."""
        if not self._distributed:
            return True
        import torch.distributed as dist
        return dist.get_rank(self.solver._schedule.group) == 0

    def _broadcast_step(self, step: int | None) -> int | None:
        """Rank 0's restore decision on every rank of the group."""
        if not self._distributed:
            return step
        import torch.distributed as dist
        group = self.solver._schedule.group
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device=self.solver.device)
        src = 0 if group is None else dist.get_global_rank(group, 0)
        dist.broadcast(t, src=src, group=group)
        step = int(t.item())
        return None if step < 0 else step

    # -- checkpoint I/O ------------------------------------------------------

    def _snapshot(self, rs: RunState) -> tuple[dict, dict] | None:
        """Gather the full resumable state and copy it to the host (the
        synchronous part of a save): every rank takes part in the gathers;
        the writer gets (arrays, meta), the other ranks None."""
        schedule = self.solver._schedule
        W, H = schedule.collect(rs.W, rs.Ht)
        rule_state, residuals = schedule.split_state(rs.state)
        if residuals is not None:
            residuals = schedule.gather_residuals(residuals)
        if not self._is_writer():
            return None
        arrays: dict[str, np.ndarray] = {
            "W": _host(W), "H": _host(H),
            "rel_errors": (np.concatenate(
                [np.asarray(r, np.float32) for r in rs.rel_history])
                if rs.rel_history else np.zeros((0,), np.float32)),
        }
        if rule_state is not None:
            arrays.update(_flatten_keyed(rule_state, "rule" + _SEP))
        if residuals is not None:
            arrays.update(_flatten_keyed(residuals, "res" + _SEP))
        meta = {"step": rs.step, "time": time.time(),
                "m": rs.m, "n": rs.n, "dtype": _dtype_name(rs.dtype),
                "segment_iters": self.segment_iters, "seed": rs.seed,
                "fingerprint": self.solver.config_fingerprint()}
        return arrays, meta

    def _wait_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _save(self, rs: RunState) -> str:
        path = os.path.join(self.ckpt_dir, f"step_{rs.step:08d}")
        t0 = time.perf_counter()
        with self._tracer.span("elastic.save", step=rs.step):
            self._wait_writer()                 # one write in flight
            snap = self._snapshot(rs)

        def _write():
            _ckpt.write_payload(path, *snap)
            _ckpt._prune(self.ckpt_dir, self.keep_last)

        def _write_async():
            try:
                _write()
            except Exception as e:              # raised by _wait_writer
                self._write_error = e

        if snap is not None:
            # A fault plan mutates the payload right after the save — that
            # needs the bytes on disk now, so chaos runs write synchronously.
            if self.async_save and self.fault_plan is None:
                self._writer = threading.Thread(target=_write_async,
                                                daemon=True,
                                                name="elastic-writer")
                self._writer.start()
            else:
                _write()
        blocked = time.perf_counter() - t0
        self.ckpt_block_seconds.observe(blocked)
        self.saves.inc()
        log_event(_log, "checkpoint_saved", step=rs.step, path=path,
                  blocked_s=f"{blocked:.6f}")
        if self.fault_plan is not None:
            if snap is not None:
                self.fault_plan.after_save(rs.step, path)
            elif rs.step in self.fault_plan.crash_at:
                raise InjectedFault(
                    f"injected crash after the checkpoint at step {rs.step}")
        return path

    def latest_valid(self) -> tuple[int, dict, dict] | None:
        """(step, arrays, meta) of the newest checkpoint that loads and
        verifies — repairing torn saves and skipping corrupt payloads on
        the way down.  On a grid rank 0 scans and every rank reads the
        step it chose."""
        found = self._scan() if self._is_writer() else None
        step = self._broadcast_step(None if found is None else found[0])
        if step is None:
            return None
        if found is None:                    # a rank other than the writer
            path = os.path.join(self.ckpt_dir, f"step_{step:08d}")
            found = (step, *_ckpt.read_payload(path))
        _, arrays, meta = found
        return int(meta.get("step", step)), arrays, meta

    def _scan(self) -> tuple[int, dict, dict] | None:
        """(directory step, arrays, meta) of the newest payload that
        verifies."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        for step in _candidate_steps(self.ckpt_dir):
            path = os.path.join(self.ckpt_dir, f"step_{step:08d}")
            if _ckpt.recover_payload(path):
                self.recovered_payloads.inc()
                log_event(_log, "torn_save_recovered", step=step, path=path)
            if not os.path.isdir(path):
                continue
            try:
                arrays, meta = _ckpt.read_payload(path)
            except _ckpt.CheckpointCorrupt as e:
                self.corrupt_payloads.inc()
                log_event(_log, "corrupt_checkpoint_skipped", step=step,
                          path=path, error=type(e).__name__,
                          level=30)      # logging.WARNING
                continue
            return step, arrays, meta
        return None

    def _check_fingerprint(self, meta: dict) -> None:
        saved = meta.get("fingerprint", {})
        mine = self.solver.config_fingerprint()
        for fld in ENFORCED_FINGERPRINT:
            if saved.get(fld) != mine.get(fld):
                raise CheckpointMismatch(
                    f"checkpoint fingerprint field {fld!r} = "
                    f"{saved.get(fld)!r} does not match this solver's "
                    f"{mine.get(fld)!r}; refusing to resume under a "
                    f"different problem identity (layout fields like the "
                    f"grid may change, k/rule may not)")

    # -- the run -------------------------------------------------------------

    def _restore(self, A, step: int, arrays: dict, meta: dict) -> RunState:
        solver = self.solver
        m, n = A.shape
        if tuple(arrays["W"].shape) != (m, solver.k) or \
                tuple(arrays["H"].shape) != (solver.k, n):
            raise CheckpointMismatch(
                f"checkpoint factors W{arrays['W'].shape} / "
                f"H{arrays['H'].shape} do not fit problem "
                f"({m}, {n}) at k={solver.k}")
        rs = solver.prepare_state(A, W0=arrays["W"], H0=arrays["H"])
        t_rule, t_res = solver._schedule.split_state(rs.state)
        rule_state = None
        if t_rule is not None:
            rule_state = _unflatten_keyed(t_rule, arrays, "rule" + _SEP)
        had_res = any(k.startswith("res" + _SEP) for k in arrays)
        residuals = None
        if had_res and t_res is not None:
            residuals = _unflatten_keyed(t_res, arrays, "res" + _SEP)
        kept = solver.restore_carry(rs, rule_state=rule_state,
                                    residuals=residuals)
        if had_res and (residuals is None or not kept):
            self.residual_reinits.inc()
            log_event(_log, "panel_residuals_reinitialised", step=step,
                      saved_grid=str(meta.get("fingerprint", {}).get("grid")),
                      new_grid=str(solver.config_fingerprint()["grid"]))
        rs.step = step
        rs.seed = meta.get("seed")
        rels = arrays.get("rel_errors")
        if rels is not None and rels.size:
            rs.rel_history = [torch.from_numpy(np.asarray(rels, np.float32))]
        self.restores.inc()
        log_event(_log, "run_resumed", step=step,
                  saved_grid=str(meta.get("fingerprint", {}).get("grid")),
                  new_grid=str(solver.config_fingerprint()["grid"]))
        return rs

    def _converged(self, rs: RunState) -> bool:
        """Host-side evaluation of the solver's adaptive stopping criterion
        over the accumulated rel-error history (segment-granular; the same
        on every rank of a grid: the rel errors come from all-reduced
        values)."""
        crit = self.solver.stopping
        if not crit.adaptive or not rs.rel_history:
            return False
        rels = np.concatenate([np.asarray(r, np.float32)
                               for r in rs.rel_history])
        if crit.tol is not None and rels[-1] <= crit.tol:
            return True
        if crit.stall_iters:
            best, stall = np.inf, 0
            for r in rels:
                stall = 0 if r < best - crit.stall_tol else stall + 1
                best = min(best, float(r))
            return stall >= crit.stall_iters
        return False

    def _run_segment_with_retry(self, rs: RunState, seg: int) -> None:
        attempt = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.before_segment(rs.step)
                with self._tracer.span("elastic.segment", step=rs.step,
                                       iters=seg):
                    self.solver.run_segment(rs, seg)
                return
            except TransientFault as e:
                if attempt >= self.retry.max_retries:
                    log_event(_log, "segment_retries_exhausted",
                              step=rs.step, attempts=attempt, level=40)
                    raise
                delay = self.retry.delay(attempt)
                attempt += 1
                self.retries.inc()
                log_event(_log, "segment_retry", step=rs.step,
                          attempt=attempt, delay_s=delay,
                          error=str(e), level=30)
                if delay:
                    time.sleep(delay)

    def fit(self, A, *, seed: int | None = None, W0=None, H0=None,
            init=None, max_iters: int | None = None):
        """Segmented ``solver.fit(A)`` with auto-restore.  Fresh-start
        arguments (``seed``/``W0``/``H0``/``init``) apply only when no
        checkpoint exists; a valid checkpoint always wins (its factors ARE
        the run).  Returns the same ``NMFResult`` a plain fit would."""
        solver = self.solver
        total = solver.stopping.max_iters if max_iters is None else max_iters
        loaded = self.latest_valid()
        if loaded is not None:
            step, arrays, meta = loaded
            self._check_fingerprint(meta)
            with self._tracer.span("elastic.restore", step=step):
                rs = self._restore(A, step, arrays, meta)
        else:
            rs = solver.prepare_state(A, seed=seed, W0=W0, H0=H0, init=init)
            log_event(_log, "run_started", total_iters=total,
                      segment_iters=self.segment_iters,
                      fingerprint=str(solver.config_fingerprint()["rule"]))
        try:
            while rs.step < total:
                seg = min(self.segment_iters, total - rs.step)
                self._run_segment_with_retry(rs, seg)
                self._save(rs)
                if self._converged(rs):
                    log_event(_log, "run_converged", step=rs.step)
                    break
        finally:
            self._wait_writer()
        return solver.collect_result(rs)
