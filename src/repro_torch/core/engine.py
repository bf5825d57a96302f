"""AU-NMF solver engine: one solver lifecycle over a pluggable local-compute
layer and a pluggable update rule.  Counterpart of ``repro/core/engine.py``,
serial schedule only.

* **backend** — a ``repro_torch.backends.LocalOps`` implementation of the
  local products (A·Hᵀ, AᵀW, XᵀX): ``cuda`` (the hand-written kernels, the
  default), ``dense`` (``torch.matmul``) or ``sparse`` (a ``BlockCOO`` or
  sparse tensor A through the SpMM kernels; the factors stay dense).
* **algo** — a ``repro_torch.core.rules.UpdateRule``: ``mu``, ``hals``,
  ``bpp`` (aliases ``abpp`` / ``anls``), or anything registered.
* **device** — ``cuda`` unless the caller passes ``device="cpu"``; asking
  for CUDA without a card raises.

Stopping: fixed iterations (the paper's benchmark protocol), relative-error
tolerance, and stall detection.  PyTorch runs eagerly, so the reference's
``lax.scan`` / ``lax.while_loop`` become host loops: a fixed run keeps the
rel errors on the device and syncs once at the end; an adaptive run reads
each iteration's rel error back (one sync per iteration) and applies the
reference's stopping test in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import backends as _backends
from repro_torch.core import rules as _rules
from repro_torch.core.aunmf import NMFResult, aunmf_step_rule, init_h, init_w
from repro_torch.util.convert import to_torch
from repro_torch.util.device import make_generator, resolve_device

SCHEDULES = ("serial", "faun", "naive", "gspmd")
_PORTED_SCHEDULES = ("serial",)


# ---------------------------------------------------------------------------
# Stopping criteria
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StoppingCriterion:
    """When to halt the alternating updates.

    ``max_iters`` always bounds the loop.  ``tol`` halts once the relative
    error drops to it; ``stall_iters`` halts after that many consecutive
    iterations without an improvement larger than ``stall_tol``.
    """

    max_iters: int = 30
    tol: float | None = None
    stall_iters: int = 0
    stall_tol: float = 1e-6

    @property
    def adaptive(self) -> bool:
        return self.tol is not None or self.stall_iters > 0


# ---------------------------------------------------------------------------
# Prepared run state — the segment API's carry
# ---------------------------------------------------------------------------

@dataclass
class RunState:
    """Device-resident state of an in-flight run, between segments.

    ``prepare_state`` builds one, ``run_segment`` advances it in place and
    ``collect_result`` packs it into an ``NMFResult``.  Segments of a fixed
    run compose bit-identically to one longer run (the same step on the
    same state).  ``rel_history`` holds one rel-error tensor per segment;
    ``seed`` is the seed the factors were drawn from (None for explicit or
    warm-started factors).
    """

    A: Any
    W: Any
    Ht: Any
    normA_sq: Any
    state: Any
    step: int = 0
    rel_history: list = field(default_factory=list)
    seed: int | None = None


class _SerialSchedule:
    """Paper Algorithm 1 on one device."""

    name = "serial"

    def __init__(self, solver: "NMFSolver"):
        self.s = solver

    def prepare(self, A, W0, H0):
        return A, W0, H0.T.contiguous(), self.s.ops.norm_sq(A)

    def step(self, A, W, Ht, normA_sq, state):
        ops = self.s.ops
        return aunmf_step_rule(A, W, Ht, self.s.rule, state, normA_sq,
                               mm=ops.mm, mm_t=ops.mm_t, gram=ops.gram)

    def init_carry(self, m, n, dtype):
        return self.s.rule.init_state(m, n, self.s.k, dtype)

    def collect(self, W, Ht):
        return W, Ht.T.contiguous()


def _warm_start_factors(init, m: int, n: int, k: int, dtype, rule, device):
    """Resolve ``fit(init=...)`` into (W0, H0): an ``NMFResult`` (of either
    package, its factors as tensors or numpy arrays) or a plain ``(W, H)``
    pair.  Multiplicative rules (``positive_init``) get their warm factors
    floored at the dtype eps, so exact zeros do not lock entries at zero."""
    if hasattr(init, "W") and hasattr(init, "H"):
        W0, H0 = init.W, init.H
    elif isinstance(init, (tuple, list)) and len(init) == 2:
        W0, H0 = init
    else:
        raise TypeError(f"init must be an NMFResult or a (W, H) pair; got "
                        f"{type(init).__name__}")
    W0 = to_torch(W0, device=device, dtype=dtype)
    H0 = to_torch(H0, device=device, dtype=dtype)
    if tuple(W0.shape) != (m, k):
        raise ValueError(f"warm-start W has shape {tuple(W0.shape)}, problem "
                         f"needs {(m, k)}")
    if tuple(H0.shape) != (k, n):
        raise ValueError(f"warm-start H has shape {tuple(H0.shape)}, problem "
                         f"needs {(k, n)}")
    if rule.positive_init:
        eps = _rules.eps_for(dtype)
        W0 = torch.clamp_min(W0, eps)
        H0 = torch.clamp_min(H0, eps)
    return W0.contiguous(), H0.contiguous()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class NMFSolver:
    """One solver lifecycle for the serial schedule × local-compute backend
    × update rule.

    >>> solver = NMFSolver(k=50, algo="bpp", max_iters=30)   # cuda, kernels
    >>> result = solver.fit(A)              # A: dense tensor or numpy array
    >>> result = solver.fit(A, init=result)  # warm start
    >>> NMFSolver(k=50, backend="sparse").fit(A_sparse)   # BlockCOO / COO

    ``fit(init=...)`` warm-starts from previously trained factors — an
    ``NMFResult`` of either package, or a plain ``(W, H)`` pair.
    """

    def __init__(self, k: int, *, algo: "_rules.RuleSpec" = "bpp",
                 schedule: str = "serial",
                 backend: "_backends.BackendSpec" = "cuda",
                 device: "str | torch.device | None" = None,
                 max_iters: int = 30, tol: float | None = None,
                 stall_iters: int = 0, stall_tol: float = 1e-6):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"choose from {SCHEDULES}")
        if schedule not in _PORTED_SCHEDULES:
            raise NotImplementedError(
                f"schedule {schedule!r} is not ported to repro_torch yet "
                f"(ROADMAP.md, queue 1: items 6 'faun' and 8 'the other "
                f"schedules'); use schedule='serial'")
        self.rule = self._base_rule = _rules.get_rule(algo)
        self.ops = _backends.get_backend(backend)
        self.device = resolve_device(device)
        self.k, self.algo = k, self.rule.name
        self.stopping = StoppingCriterion(max_iters=max_iters, tol=tol,
                                          stall_iters=stall_iters,
                                          stall_tol=stall_tol)
        self._schedule = _SerialSchedule(self)

    @property
    def schedule(self) -> str:
        return self._schedule.name

    @property
    def backend(self) -> str:
        return self.ops.name

    # -- solver lifecycle ---------------------------------------------------

    def fit(self, A, *, seed: int | None = None, H0=None, W0=None,
            init=None) -> NMFResult:
        rs = self.prepare_state(A, seed=seed, H0=H0, W0=W0, init=init)
        if self.stopping.adaptive:
            self._adaptive_loop(rs, self.stopping)
        else:
            self.run_segment(rs, self.stopping.max_iters)
        return self.collect_result(rs)

    # -- segment API --------------------------------------------------------

    def prepare_state(self, A, *, seed: int | None = None, H0=None, W0=None,
                      init=None) -> RunState:
        """Resolve factors and lay the problem out, without running any
        iterations.  Explicit ``W0``/``H0`` are installed as given (cast to
        A's dtype, on the solver's device); ``init=`` warm starts go through
        the eps-flooring of ``_warm_start_factors``.  Random factors come
        from a ``torch.Generator`` on the solver's device seeded with
        ``seed`` (default 0): H first, then W.  A is whatever the backend's
        ``prepare`` makes of it (a tensor, or a ``BlockCOO``); only its
        ``shape`` and ``dtype`` are read here."""
        A = self.ops.prepare(A, self.device)
        m, n = A.shape
        dtype = A.dtype
        self.rule = self._base_rule.prepare_global(m, n, self.k)
        if init is not None:
            if H0 is not None or W0 is not None:
                raise ValueError("pass either init= (a warm start) or "
                                 "explicit W0/H0, not both")
            W0, H0 = _warm_start_factors(init, m, n, self.k, dtype,
                                         self.rule, self.device)
        used_seed = None
        if H0 is None or W0 is None:
            used_seed = 0 if seed is None else int(seed)
            gen = make_generator(self.device, used_seed)
            H_rand = init_h(gen, n, self.k, dtype=dtype)
            W_rand = init_w(gen, m, self.k, self.rule, dtype=dtype)
            H0 = H_rand if H0 is None else H0
            W0 = W_rand if W0 is None else W0
        W0 = to_torch(W0, device=self.device, dtype=dtype).contiguous()
        H0 = to_torch(H0, device=self.device, dtype=dtype)
        A, W, Ht, normA_sq = self._schedule.prepare(A, W0, H0)
        state0 = self._schedule.init_carry(m, n, dtype)
        return RunState(A=A, W=W, Ht=Ht, normA_sq=normA_sq, state=state0,
                        seed=used_seed)

    def run_segment(self, rs: RunState, iters: int) -> RunState:
        """Advance ``iters`` fixed iterations in place.  The rel errors stay
        on the device until the segment ends: one sync per segment."""
        if iters <= 0:
            return rs
        rels = torch.empty((iters,), dtype=torch.float32, device=self.device)
        W, Ht, state = rs.W, rs.Ht, rs.state
        for i in range(iters):
            W, Ht, sq, state = self._step(rs, W, Ht, state)
            rels[i] = _rel_error(sq, rs.normA_sq)
        rs.W, rs.Ht, rs.state = W, Ht, state
        rs.step += iters
        rs.rel_history.append(rels.cpu())
        return rs

    def collect_result(self, rs: RunState) -> NMFResult:
        """Pack a run state into an ``NMFResult``: H back to (k, n), the
        per-segment rel-error history concatenated on the host."""
        W, H = self._schedule.collect(rs.W, rs.Ht)
        rels = (torch.cat(rs.rel_history) if rs.rel_history
                else torch.zeros((0,), dtype=torch.float32))
        extras = {"schedule": self.schedule, "backend": self.backend,
                  "device": str(self.device),
                  "stopped_early": rs.step < self.stopping.max_iters,
                  "rule_state": rs.state}
        return NMFResult(W=W, H=H, rel_errors=rels, algo=self.algo,
                         iters=rs.step, extras=extras)

    # -- loops ---------------------------------------------------------------

    def _step(self, rs: RunState, W, Ht, state):
        Wn, Htn, sq, state = self._schedule.step(rs.A, W, Ht, rs.normA_sq,
                                                 state)
        # Backends emit fp32 from low-precision factors (fp32 accumulation);
        # restore the carry dtype (no-op for fp32 runs).
        return Wn.to(W.dtype), Htn.to(Ht.dtype), sq, state

    def _adaptive_loop(self, rs: RunState, crit: StoppingCriterion) -> None:
        """The reference's while-loop on the host: the stopping test runs in
        fp32 on each iteration's rel error (one sync per iteration)."""
        f32 = np.float32
        tol = None if crit.tol is None else f32(crit.tol)
        stall_tol = f32(crit.stall_tol)
        best, stall, rels = f32(np.inf), 0, []
        W, Ht, state = rs.W, rs.Ht, rs.state
        for _ in range(crit.max_iters):
            W, Ht, sq, state = self._step(rs, W, Ht, state)
            rel = f32(_rel_error(sq, rs.normA_sq).item())
            rels.append(rel)
            stall = 0 if rel < best - stall_tol else stall + 1
            best = min(best, rel)
            if ((tol is not None and rel <= tol)
                    or (crit.stall_iters and stall >= crit.stall_iters)):
                break
        rs.W, rs.Ht, rs.state = W, Ht, state
        rs.step += len(rels)
        rs.rel_history.append(torch.tensor(rels, dtype=torch.float32))


def _rel_error(sq: torch.Tensor, normA_sq: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(sq, 0.0) / normA_sq)
