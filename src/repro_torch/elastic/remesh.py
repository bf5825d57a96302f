"""Re-meshing: resume a checkpointed run on another pr×pc grid, process
group, schedule, backend or device — the counterpart of
``repro/elastic/remesh.py``.

Elastic checkpoints are **mesh-agnostic by construction**: the runner
snapshots the GLOBAL factors (W, H), the rule state (the same on every
rank), and the rel-error history — nothing in the payload encodes a layout
except the provenance fingerprint and the residuals' stacked shapes.
Resuming on a new layout is "construct a solver for the new layout,
restore into it": the schedule's ``prepare_A`` blocks A for the new grid
(dense row or column blocks; a BlockCOO re-blocks through
``blocksparse.blockify``, sorted layouts included) and ``restore_carry``
lays the carry out for it.

Parity across a remesh:

  * **exact wire format** — bit-identical to the uninterrupted run on the
    new grid from the same factors: the carry is factors and the rule's
    state, nothing grid-shaped.
  * **compressed panels** (``panel_compression="int8"``) — the
    error-feedback residuals are grid-SHAPED, so a grid change re-zeroes
    them (counted as ``elastic_residual_reinits_total``); the resumed run
    matches the uninterrupted one within the compression tolerance.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as _ckpt
from repro_torch.core.engine import NMFSolver


@dataclasses.dataclass(frozen=True)
class ElasticCheckpoint:
    """One loaded elastic payload, layout-free: global factors + history +
    the writing solver's provenance (numpy arrays, as read)."""

    step: int
    W: np.ndarray
    H: np.ndarray
    rel_errors: np.ndarray
    arrays: dict
    meta: dict

    @property
    def fingerprint(self) -> dict:
        return self.meta.get("fingerprint", {})

    def to_result(self):
        """An ``NMFResult`` view of the checkpoint (CPU tensors) — what warm
        starts (``fit(init=)``) and the online loop's lineage root
        (``OnlineNMF.from_checkpoint``) consume."""
        from repro_torch.core.aunmf import NMFResult
        fp = self.fingerprint
        return NMFResult(W=torch.from_numpy(np.asarray(self.W)),
                         H=torch.from_numpy(np.asarray(self.H)),
                         rel_errors=torch.from_numpy(
                             np.asarray(self.rel_errors, np.float32)),
                         algo=fp.get("algo", "unknown"), iters=self.step,
                         extras={"schedule": fp.get("schedule"),
                                 "backend": fp.get("backend"),
                                 "restored_step": self.step})


def load_checkpoint(ckpt_dir: str, *, step: int | None = None
                    ) -> ElasticCheckpoint:
    """Load the newest valid payload under ``ckpt_dir`` (or an exact
    ``step``), repairing torn saves and skipping corrupt payloads the same
    way ``ElasticRunner.fit``'s restore scan does.  Reads either package's
    payloads."""
    from repro_torch.elastic.runner import _candidate_steps
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    candidates = ([step] if step is not None
                  else _candidate_steps(ckpt_dir))
    last_err: Exception | None = None
    for s in candidates:
        path = os.path.join(ckpt_dir, f"step_{s:08d}")
        _ckpt.recover_payload(path)
        if not os.path.isdir(path):
            continue
        try:
            arrays, meta = _ckpt.read_payload(path)
        except _ckpt.CheckpointCorrupt as e:
            last_err = e
            continue
        return ElasticCheckpoint(
            step=int(meta.get("step", s)), W=arrays["W"], H=arrays["H"],
            rel_errors=arrays.get("rel_errors",
                                  np.zeros((0,), np.float32)),
            arrays=arrays, meta=meta)
    raise (last_err or FileNotFoundError(
        f"no valid checkpoint under {ckpt_dir}"))


def remesh_solver(solver: NMFSolver, *, schedule: str | None = None,
                  grid=None, group=None, backend=None,
                  device=None) -> NMFSolver:
    """A new solver with the SAME problem identity (k, rule, stopping
    criterion, ``panel_dtype``, ``panel_compression``) on another layout —
    exactly the fields a resume may change: ``schedule``, ``grid`` (a
    ``FaunGrid``), ``group`` (naive's process group), ``backend`` and
    ``device`` (each None: the old solver's, the grid and group None: the
    new schedule's default).  The enforced fingerprint (k + rule) is
    preserved by construction, so the remeshed solver accepts the old
    solver's checkpoints."""
    crit = solver.stopping
    return NMFSolver(
        solver.k, algo=solver._base_rule,
        schedule=schedule or solver.schedule,
        backend=solver.ops if backend is None else backend,
        device=solver.device if device is None else device,
        grid=grid, group=group,
        max_iters=crit.max_iters, tol=crit.tol,
        stall_iters=crit.stall_iters, stall_tol=crit.stall_tol,
        panel_dtype=solver.panel_dtype,
        panel_compression=solver.panel_compression)


def resume(solver: NMFSolver, ckpt_dir: str, A, *,
           segment_iters: int = 10, max_iters: int | None = None,
           **runner_kw):
    """Resume (and finish) a checkpointed run under ``solver`` — which may
    be laid out on another grid/schedule/backend than the solver that
    wrote the checkpoints.  Thin wrapper over ``ElasticRunner.fit``."""
    from repro_torch.elastic.runner import ElasticRunner
    runner = ElasticRunner(solver, ckpt_dir, segment_iters=segment_iters,
                           **runner_kw)
    return runner.fit(A, max_iters=max_iters)
