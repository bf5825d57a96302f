"""Host-side training loop: checkpoint/restart, straggler watchdog, elastic
re-meshing.  Counterpart of ``repro/train/loop.py``.

Fault-tolerance model:
  * state durability — async atomic checkpoints every ``ckpt_every`` steps;
    restart resumes bit-exactly because the data pipeline is a pure
    function of (seed, step) and the optimizer state is checkpointed;
  * node failure — the loop catches a failed step, restores the last
    checkpoint and continues (exercised by ``inject_failure_at``); after
    losing ranks, ``elastic_resume`` rebuilds a mesh over the survivors and
    restores onto it;
  * stragglers — a per-step watchdog thread flags steps exceeding
    ``straggler_factor`` × the rolling median wall time.

A state sharded over ranks (``train.steps.shard_state``) is gathered for
each save, rank 0 writes it and every rank waits for the write before a
restore; a restored state is sharded again onto the same placements.
"""

from __future__ import annotations

import logging
import math
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt_lib

log = logging.getLogger("repro_torch.train")


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_min_history: int = 5
    max_failures: int = 3


class StragglerWatchdog:
    """Flags steps that exceed straggler_factor × rolling median wall time."""

    def __init__(self, factor: float, min_history: int,
                 on_straggler: Callable[[int, float, float], None]
                 | None = None):
        self.factor = factor
        self.min_history = min_history
        self.history: list[float] = []
        self.events: list[tuple[int, float, float]] = []
        self._on = on_straggler
        self._timer: threading.Timer | None = None

    def median(self) -> float | None:
        if len(self.history) < self.min_history:
            return None
        return statistics.median(self.history[-50:])

    def step_started(self, step: int):
        med = self.median()
        if med is not None:
            deadline = self.factor * med

            def fire():
                self.events.append((step, deadline, med))
                if self._on:
                    self._on(step, deadline, med)
                log.warning("straggler: step %d exceeded %.3fs (median %.3fs)",
                            step, deadline, med)

            self._timer = threading.Timer(deadline, fire)
            self._timer.daemon = True
            self._timer.start()

    def step_finished(self, dur: float):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self.history.append(dur)


def _mesh_of(state):
    """The ``DeviceMesh`` a sharded state lives on, or None."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim.optimizers import tree_leaves
    for leaf in tree_leaves(state):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def train(state, train_step, batch_fn, loop_cfg: LoopConfig, *,
          checkpointer: ckpt_lib.AsyncCheckpointer | None = None,
          on_metrics: Callable[[int, dict], None] | None = None,
          inject_failure_at: int | None = None):
    """Run until total_steps; returns (state, metrics_history).

    ``inject_failure_at`` raises a synthetic RuntimeError once at that step
    (fault-tolerance tests): the loop restores from the last checkpoint and
    continues, and the final state must be bit-identical to an uninterrupted
    run."""
    from repro_torch.train.steps import full_state, shard_state
    cp = checkpointer or ckpt_lib.AsyncCheckpointer(loop_cfg.ckpt_dir,
                                                    loop_cfg.keep_last)
    watchdog = StragglerWatchdog(loop_cfg.straggler_factor,
                                 loop_cfg.straggler_min_history)
    mesh = _mesh_of(state)
    writer = mesh is None or dist.get_rank() == 0
    history: list[dict] = []
    failures = 0
    injected = False

    def save(step):
        whole = full_state(state) if mesh is not None else state
        if writer:
            cp.save(whole, step)

    step = int(state["step"])
    while step < loop_cfg.total_steps:
        try:
            if inject_failure_at is not None and step == inject_failure_at \
                    and not injected:
                injected = True
                raise RuntimeError("synthetic node failure")
            batch = batch_fn(step)
            watchdog.step_started(step)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            _sync(metrics["loss"])
            dur = time.time() - t0
            watchdog.step_finished(dur)
            step += 1
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["sec"] = dur
            history.append(m)
            if on_metrics:
                on_metrics(step, m)
            if step % loop_cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, m["loss"], dur)
            if step % loop_cfg.ckpt_every == 0 or step == loop_cfg.total_steps:
                save(step)
        except Exception as e:  # noqa: BLE001 — the fault-tolerance boundary
            failures += 1
            log.warning("step %d failed (%s); restore attempt %d", step, e,
                        failures)
            if failures > loop_cfg.max_failures:
                raise
            cp.wait()
            if mesh is not None:
                dist.barrier()
            template = full_state(state) if mesh is not None else state
            restored, rstep = ckpt_lib.restore(loop_cfg.ckpt_dir, template)
            if restored is None:
                log.warning("no checkpoint yet; restarting from current state")
            else:
                state = (shard_state(restored, mesh) if mesh is not None
                         else restored)
                step = rstep
    cp.wait()
    if mesh is not None:
        dist.barrier()
    return state, history


# ------------------------------------------------------------------ elastic

def largest_mesh_shape(n_devices: int, prefer_model: int = 1):
    """(data, model) grid for an arbitrary device count (elastic re-mesh)."""
    model = math.gcd(prefer_model, n_devices) if prefer_model > 1 else 1
    return (n_devices // model, model)


def elastic_resume(template_state, ckpt_dir: str, ranks=None, *,
                   prefer_model: int = 1):
    """Rebuild a ("data", "model") ``DeviceMesh`` over the surviving
    ``ranks`` (default: every rank of the current process group) and
    restore the latest checkpoint onto it, sharded by the rules.
    Checkpoints are mesh-agnostic (host npz), so any new topology works as
    long as shapes divide.  Every rank
    of the group calls it; a rank outside ``ranks`` gets (None, step,
    mesh).  The mesh lies on the device type of ``template_state``'s
    tensors.  Returns (state, step, mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import full_state, shard_state
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    d, m = largest_mesh_shape(len(ranks), prefer_model)
    device_type = tree_leaves(template_state)[0].device.type
    mesh = DeviceMesh(device_type,
                      torch.tensor(ranks[:d * m]).reshape(d, m),
                      mesh_dim_names=("data", "model"))
    state, step = ckpt_lib.restore(ckpt_dir, full_state(template_state))
    if mesh.get_coordinate() is None:
        return None, step, mesh
    if state is not None:
        state = shard_state(state, mesh)
    return state, step, mesh
