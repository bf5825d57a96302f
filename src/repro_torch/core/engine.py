"""AU-NMF solver engine: one solver lifecycle over a pluggable local-compute
layer and a pluggable update rule.  Counterpart of ``repro/core/engine.py``.

* **schedule** — who computes which block and which collectives move the
  k-width panels: ``serial`` (Algorithm 1, one device), ``faun``
  (Algorithm 3 on a pr × pc grid of ``torch.distributed`` ranks,
  ``core/faun.py``), ``naive`` (Algorithm 2 on a 1-D group,
  ``core/naive.py``) or ``gspmd`` (the same iteration as a global-view
  program over ``torch.distributed.tensor``, whose sharding propagation
  picks the collectives, ``core/gspmd.py``).

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

The distributed schedules share ``panel_compression="int8"``: error-feedback
int8 quantisation of the panel collectives (``distributed/compression.py``),
the residuals carried through the same loops beside the rule's state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import backends as _backends
from repro_torch.core import rules as _rules
from repro_torch.core.aunmf import NMFResult, aunmf_step_rule, init_h, init_w
from repro_torch.obs.trace import active_tracer, use_tracer
from repro_torch.util.convert import to_torch
from repro_torch.util.device import make_generator, resolve_device

SCHEDULES = ("serial", "faun", "naive", "gspmd")


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
    ``m``, ``n`` and ``dtype`` are the global problem's (what a snapshot
    records); ``seed`` is the seed the factors were drawn from (None for
    explicit or warm-started factors).
    """

    A: Any
    W: Any
    Ht: Any
    normA_sq: Any
    state: Any
    m: int = 0
    n: int = 0
    dtype: Any = torch.float32
    step: int = 0
    rel_history: list = field(default_factory=list)
    seed: int | None = None


class _SerialSchedule:
    """Paper Algorithm 1 on one device.  A schedule lays the problem out
    (``prepare_A``, ``place_factors``), runs one iteration on its layout
    (``step``) and gathers the factors back (``collect``)."""

    name = "serial"
    grid_shape = (1, 1)

    def __init__(self, solver: "NMFSolver"):
        self.s = solver

    def prepare_A(self, A):
        """(A as this schedule holds it, the global (m, n), the carry dtype,
        ‖A‖²)."""
        A = self.s.ops.prepare(A, self.s.device)
        return A, tuple(A.shape), A.dtype, self.s.ops.norm_sq(A)

    def place_factors(self, W0, H0):
        return W0, H0.T.contiguous()

    def step(self, A, W, Ht, normA_sq, state):
        ops = self.s.ops
        return aunmf_step_rule(A, W, Ht, self.s.rule, state, normA_sq,
                               mm=ops.mm, mm_t=ops.mm_t, gram=ops.gram)

    def init_carry(self, m, n, dtype):
        """The loop's carry: the rule's state, extended to ``(rule_state,
        residuals)`` by schedules running compressed panel collectives."""
        state = self.s.rule.init_state(m, n, self.s.k, dtype)
        if self.s.compress is None:
            return state
        return (state, self.init_residuals(m, n))

    def split_state(self, state):
        """(rule_state, residuals or None) from the loop's carry."""
        if self.s.compress is None:
            return state, None
        return state

    def collect(self, W, Ht):
        return W, Ht.T.contiguous()

    # -- abstract arguments (lower_step) --------------------------------------

    def _abstract_factors(self, rows_w: int, rows_h: int, dtype):
        dev, k = self.s.device, self.s.k
        return (torch.empty((rows_w, k), dtype=dtype, device=dev),
                torch.empty((rows_h, k), dtype=dtype, device=dev),
                torch.empty((), dtype=torch.float32, device=dev))

    def abstract_args(self, m, n, dtype, nnz):
        """``step``'s (A, W, Hᵀ, ‖A‖²) as this rank holds them for a global
        m × n problem (``nnz`` triplets for a sparse backend), as tensors
        without data: call it under a ``FakeTensorMode``."""
        A = self.s.ops.abstract_A(m, n, dtype, nnz, 1, 1, self.s.device)
        return (A,) + self._abstract_factors(m, n, dtype)

    # -- the error-feedback residuals in the reference's stacked layout ------

    #: whether the schedule runs on torch.distributed ranks, and the
    #: process group every one of them is in (None: the default group)
    distributed = False
    group = None
    #: leading dimensions of a residual in the reference's stacked global
    #: layout (faun (pr, pc), naive (p,); gspmd's are global-shaped)
    res_stack: tuple = ()

    def res_index(self) -> tuple:
        """This rank's index into ``res_stack``."""
        return ()

    def gather_residuals(self, res: dict) -> dict:
        """The residuals of every rank, stacked as the reference lays them
        out (every rank calls it: a collective on the grid)."""
        return res

    def place_residuals(self, res: dict) -> dict:
        """The carry form of stacked global residuals (arrays or tensors):
        this rank's, fp32 on the solver's device (sliced before they
        move)."""
        idx = self.res_index()
        return {key: to_torch(v[idx] if idx else v, device=self.s.device,
                              dtype=torch.float32).contiguous()
                for key, v in res.items()}


def _stack_gather(res: dict, group, stack: tuple) -> dict:
    """Each rank's residual panels ((rows, k) leaves) gathered in rank order
    and stacked to ``stack`` + the panel's shape (one all-gather a
    leaf)."""
    from repro_torch.core.faun import allgather_panel
    return {key: allgather_panel(v, group).reshape(stack + tuple(v.shape))
            for key, v in res.items()}


def _rows(X, block: int, p: int):
    """Rows block·r/p … (block+1)·r/p of X, contiguous."""
    r = X.shape[0] // p
    return X[block * r:(block + 1) * r].contiguous()


def _check_tiles(shape, p: int) -> None:
    m, n = shape
    if m % p or n % p:
        raise ValueError(f"A of shape {(m, n)}: both dimensions must divide "
                         f"by the {p} ranks of the schedule")


class _FaunSchedule(_SerialSchedule):
    """Paper Algorithm 3 on this rank's cell of a ``FaunGrid``
    (``core/faun.py``)."""

    name = "faun"

    def __init__(self, solver: "NMFSolver", grid):
        from repro_torch.core.faun import FaunGrid, make_faun_grid
        if grid is None:
            grid = make_faun_grid(*_square_grid(_world_size("faun")))
        if not isinstance(grid, FaunGrid):
            raise TypeError(f"grid must be a FaunGrid (make_faun_grid), got "
                            f"{type(grid).__name__}")
        self.s, self.grid = solver, grid
        self.grid_shape = self.res_stack = (grid.pr, grid.pc)
        self.distributed, self.group = True, grid.world

    def res_index(self) -> tuple:
        return (self.grid.i, self.grid.j)

    def gather_residuals(self, res: dict) -> dict:
        return _stack_gather(res, self.grid.world, self.res_stack)

    def prepare_A(self, A):
        from repro_torch.core.faun import all_reduce
        g, ops = self.grid, self.s.ops
        shape = tuple(A.shape)
        _check_tiles(shape, g.p)
        blk = ops.blockify(A, g.pr, g.pc, (g.i, g.j), self.s.device)
        normA_sq = all_reduce(ops.norm_sq(blk), g.world)
        dtype = blk.dtype
        if self.s.panel_dtype is not None:
            blk = ops.cast_block(blk, self.s.panel_dtype)
        return blk, shape, dtype, normA_sq

    def place_factors(self, W0, H0):
        g = self.grid
        return _rows(W0, g.w_block, g.p), _rows(H0.T, g.ht_block, g.p)

    def step(self, A, W, Ht, normA_sq, state):
        from repro_torch.core.faun import faun_iteration
        return faun_iteration(A, W, Ht, normA_sq, state, grid=self.grid,
                              rule=self.s.rule, ops=self.s.ops,
                              panel_dtype=self.s.panel_dtype,
                              compress=self.s.compress)

    def abstract_args(self, m, n, dtype, nnz):
        g, ops = self.grid, self.s.ops
        _check_tiles((m, n), g.p)
        A = ops.abstract_A(m, n, dtype, nnz, g.pr, g.pc, self.s.device)
        if self.s.panel_dtype is not None:
            A = ops.cast_block(A, self.s.panel_dtype)
        return (A,) + self._abstract_factors(m // g.p, n // g.p, dtype)

    def init_residuals(self, m, n):
        from repro_torch.core.faun import init_faun_residuals
        return init_faun_residuals(self.grid, m, n, self.s.k,
                                   device=self.s.device)

    def collect(self, W, Ht):
        """Both factors gathered back into global order on every rank: W's
        blocks come in rank order; Hᵀ's come in rank order (i, j) and are
        written straight into H (k, n) in (pc, pr) order, one copy, before
        W is gathered (one gathered panel alive at a time)."""
        from repro_torch.core.faun import allgather_panel
        g = self.grid
        Ht = allgather_panel(Ht, g.world)
        k = Ht.shape[1]
        H = Ht.view(g.pr, g.pc, -1, k).permute(3, 1, 0, 2).reshape(k, -1)
        del Ht
        return allgather_panel(W, g.world), H.contiguous()


class _NaiveSchedule(_SerialSchedule):
    """Paper Algorithm 2 on a 1-D process group (``core/naive.py``)."""

    name = "naive"

    def __init__(self, solver: "NMFSolver", group):
        import torch.distributed as dist
        _world_size("naive")
        self.s, self.group = solver, group
        self.p = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("this rank is not in the naive schedule's group")
        self.grid_shape = (self.p, 1)
        self.res_stack = (self.p,)
        self.distributed = True

    def res_index(self) -> tuple:
        return (self.rank,)

    def gather_residuals(self, res: dict) -> dict:
        return _stack_gather(res, self.group, self.res_stack)

    def prepare_A(self, A):
        """A twice: the row block for A·Hᵀ and the column block for AᵀW,
        each told which product it serves (a sorted sparse copy carries
        only that orientation).  At p = 1 both are A itself for dense A."""
        from repro_torch.core.faun import all_reduce
        ops, p, r, dev = self.s.ops, self.p, self.rank, self.s.device
        shape = tuple(A.shape)
        _check_tiles(shape, p)
        A = ops.pre_blockify(A)
        Arow = ops.blockify(A, p, 1, (r, 0), dev, products=("mm",))
        Acol = ops.blockify(A, 1, p, (0, r), dev, products=("mm_t",))
        normA_sq = all_reduce(ops.norm_sq(Arow), self.group)
        return (Arow, Acol), shape, Arow.dtype, normA_sq

    def place_factors(self, W0, H0):
        return _rows(W0, self.rank, self.p), _rows(H0.T, self.rank, self.p)

    def step(self, A, W, Ht, normA_sq, state):
        from repro_torch.core.naive import naive_iteration
        return naive_iteration(A[0], A[1], W, Ht, normA_sq, state,
                               group=self.group, rule=self.s.rule,
                               ops=self.s.ops, compress=self.s.compress)

    def abstract_args(self, m, n, dtype, nnz):
        ops, p, dev = self.s.ops, self.p, self.s.device
        _check_tiles((m, n), p)
        A = (ops.abstract_A(m, n, dtype, nnz, p, 1, dev),
             ops.abstract_A(m, n, dtype, nnz, 1, p, dev))
        return (A,) + self._abstract_factors(m // p, n // p, dtype)

    def init_residuals(self, m, n):
        from repro_torch.core.naive import init_naive_residuals
        return init_naive_residuals(self.p, m, n, self.s.k,
                                    device=self.s.device)

    def collect(self, W, Ht):
        from repro_torch.core.faun import allgather_panel
        H = allgather_panel(Ht, self.group).T.contiguous()
        return allgather_panel(W, self.group), H


def _world_size(schedule: str) -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            f"schedule={schedule!r} runs on torch.distributed ranks, and no "
            f"process group is initialised: start the ranks with "
            f"util.dist.spawn or torchrun (util.dist.init_from_env), even "
            f"for one rank")
    return dist.get_world_size()


def _square_grid(p: int) -> tuple[int, int]:
    pr = max(d for d in range(1, p + 1) if p % d == 0 and d * d <= p)
    return pr, p // pr


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
    """One solver lifecycle for every ported schedule × local-compute
    backend × update rule.

    >>> solver = NMFSolver(k=50, algo="bpp", max_iters=30)   # cuda, kernels
    >>> result = solver.fit(A)              # A: dense tensor or numpy array
    >>> result = solver.fit(A, init=result)  # warm start
    >>> NMFSolver(k=50, backend="sparse").fit(A_sparse)   # BlockCOO / COO

    ``fit(init=...)`` warm-starts from previously trained factors — an
    ``NMFResult`` of either package, or a plain ``(W, H)`` pair.

    ``schedule="faun"`` (Algorithm 3) runs on ``grid``, a
    ``core.faun.FaunGrid`` (``make_faun_grid(pr, pc)``; None: the square
    grid over the default process group), and ``schedule="naive"``
    (Algorithm 2) on ``group``, a process group (None: the default one).
    Every rank of the grid or group calls ``fit`` with the same global A
    (and the same seed or factors), holds only its own blocks, and gets
    the same global ``NMFResult``.  Both need an initialised process group,
    even for one rank: their collectives always go through
    ``torch.distributed``.  ``schedule="gspmd"`` runs the same iteration
    as a global-view program on ``grid`` (``core/gspmd.py``).
    ``panel_dtype`` (faun only; not on the sparse backend) ships the panel
    gathers in that dtype; ``donate`` is accepted for the reference's
    signature and has no effect in eager PyTorch.

    ``panel_compression="int8"`` compresses the distributed schedules'
    panel collectives (Gram all-reduces, panel all-gathers and
    reduce-scatters) to int8 payloads with two-sided fp32 scales and
    error feedback; each rank's residuals ride the loop's carry and
    surface as ``NMFResult.extras["panel_residuals"]``
    (``distributed/compression.py``; gspmd emulates the numerics only).
    The default None keeps the exact wire bit for bit.  It does not
    compose with ``panel_dtype`` (both rewrite the wire format).
    """

    def __init__(self, k: int, *, algo: "_rules.RuleSpec" = "bpp",
                 schedule: str = "serial",
                 backend: "_backends.BackendSpec" = "cuda",
                 device: "str | torch.device | None" = None,
                 grid=None, group=None,
                 max_iters: int = 30, tol: float | None = None,
                 stall_iters: int = 0, stall_tol: float = 1e-6,
                 panel_dtype: torch.dtype | None = None,
                 panel_compression: str | None = None,
                 donate: bool = False):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"choose from {SCHEDULES}")
        self.rule = self._base_rule = _rules.get_rule(algo)
        self.ops = _backends.get_backend(backend)
        if panel_dtype is not None:
            if schedule != "faun":
                raise ValueError("panel_dtype (low-precision panel gathers) "
                                 "is implemented by the faun schedule only")
            if not self.ops.supports_panel_dtype:
                raise ValueError(f"backend {self.ops.name!r} does not "
                                 f"support low-precision panels "
                                 f"(panel_dtype)")
        self.compress = None
        if panel_compression is not None:
            from repro_torch.distributed.compression import get_compressor
            self.compress = get_compressor(panel_compression)  # checks it
            if schedule == "serial":
                raise ValueError(
                    "panel_compression compresses the distributed panel "
                    "collectives; the serial schedule has none — use "
                    "schedule='faun' (a 1×1 grid exercises the "
                    "quantisation numerics on one rank)")
            if panel_dtype is not None:
                raise ValueError(
                    "panel_dtype and panel_compression both rewrite the "
                    "panel wire format and do not compose; pick one "
                    "(int8 compression already halves bf16's panel bytes)")
        del donate
        self.device = resolve_device(device)
        self.k, self.algo = k, self.rule.name
        self.panel_dtype = panel_dtype
        self.panel_compression = panel_compression
        self.stopping = StoppingCriterion(max_iters=max_iters, tol=tol,
                                          stall_iters=stall_iters,
                                          stall_tol=stall_tol)
        if schedule == "faun":
            self._schedule = _FaunSchedule(self, grid)
        elif schedule == "naive":
            self._schedule = _NaiveSchedule(self, group)
        elif schedule == "gspmd":
            from repro_torch.core.gspmd import GspmdSchedule
            self._schedule = GspmdSchedule(self, grid)
        else:
            self._schedule = _SerialSchedule(self)

    @property
    def schedule(self) -> str:
        return self._schedule.name

    @property
    def backend(self) -> str:
        return self.ops.name

    # -- solver lifecycle ---------------------------------------------------

    def fit(self, A, *, seed: int | None = None, H0=None, W0=None,
            init=None, profile: bool = False, tracer=None) -> NMFResult:
        """Run the solver on A.  ``profile=True`` runs the same iteration
        as a chain of per-phase segments, synchronised at each boundary
        (``obs/phases.py``): the unprofiled fit's bits, plus
        ``extras["phase_times"]``, the mean seconds per iteration of each
        phase.  ``tracer`` (an ``obs.trace.Tracer``) records a
        ``phase.<key>`` span per phase and a ``phase.iteration`` span per
        iteration: host spans between the profiled loop's syncs, or,
        unprofiled, the loop's device spans, which otherwise go to the
        process-default tracer (``run_segment``)."""
        if profile and self.panel_compression is not None:
            raise ValueError(
                "profile=True times the uncompressed wire format; it does "
                "not compose with panel_compression (the compressed "
                "collectives fuse payload and sidecar into one phase the "
                "segmented profiler cannot attribute)")
        if profile and self.panel_dtype is not None:
            raise ValueError("profile=True does not compose with "
                             "panel_dtype (same wire-format reason as "
                             "panel_compression)")
        rs = self.prepare_state(A, seed=seed, H0=H0, W0=W0, init=init)
        if profile:
            from repro_torch.obs.phases import run_profiled
            phase_times = run_profiled(self, rs, tracer=tracer)
            res = self.collect_result(rs)
            res.extras["phase_times"] = phase_times
            return res
        with use_tracer(tracer or active_tracer()):
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
        ``seed`` (default 0): H first, then W, both at their global shapes,
        so every rank of a grid draws the same factors as the serial
        schedule and keeps its own rows.  A is whatever the schedule makes
        of it: the backend's ``prepare`` (serial) or this rank's blocks
        (``blockify``)."""
        A, (m, n), dtype, normA_sq = self._schedule.prepare_A(A)
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
        W, Ht = self._schedule.place_factors(W0, H0)
        del W0, H0
        state0 = self._schedule.init_carry(m, n, dtype)
        return RunState(A=A, W=W, Ht=Ht, normA_sq=normA_sq, state=state0,
                        m=m, n=n, dtype=dtype, seed=used_seed)

    def run_segment(self, rs: RunState, iters: int) -> RunState:
        """Advance ``iters`` fixed iterations in place.  The rel errors stay
        on the device until the segment ends: one sync per segment.

        Each iteration is a ``phase.iteration`` device span of the active
        tracer (``obs.trace.active_tracer()``) with ``iteration`` (the
        run's step) and ``segment`` (its index in ``rel_history``) args;
        the serial step's phases are spans inside it.  They are resolved
        after the read-back, which adds no sync."""
        if iters <= 0:
            return rs
        tracer, seg = active_tracer(), len(rs.rel_history)
        rels = torch.empty((iters,), dtype=torch.float32, device=self.device)
        W, Ht, state = rs.W, rs.Ht, rs.state
        for i in range(iters):
            with tracer.device_span("phase.iteration", self.device,
                                    iteration=rs.step + i, segment=seg):
                W, Ht, sq, state = self._step(rs, W, Ht, state)
            rels[i] = _rel_error(sq, rs.normA_sq)
        rs.W, rs.Ht, rs.state = W, Ht, state
        rs.step += iters
        rs.rel_history.append(rels.cpu())
        tracer.resolve()
        return rs

    def restore_carry(self, rs: RunState, *, rule_state=None,
                      residuals=None) -> bool:
        """Install a checkpointed loop carry into a freshly prepared state,
        laid out for THIS solver's schedule.  The rule state is the same on
        every rank and restores onto any layout (each leaf in the template
        leaf's type: a tensor's dtype and device, or a Python number).
        ``residuals`` are the panel residuals in the reference's stacked
        global layout (``res_stack`` + each rank's shape; gspmd's
        global-shaped): when their keys and shapes match this schedule's
        they are placed onto it, each rank taking its own; otherwise (a
        pr × pc remesh, a schedule change) they stay at their zero
        initialisation and the call returns False, so callers can count
        the re-initialisation.  A stateless rule refuses a checkpointed
        rule state."""
        compressed = self.compress is not None
        t_rule, t_res = self._schedule.split_state(rs.state)
        new_rule = t_rule
        if rule_state is not None:
            if t_rule is None:
                raise ValueError(
                    f"checkpoint carries rule state but rule "
                    f"{self.algo!r} is stateless — refusing to resume a "
                    f"different algorithm's carry")
            from repro_torch.checkpoint.checkpoint import _map_leaves
            saved = dict(_flat_leaves(rule_state))
            new_rule = _map_leaves(
                t_rule, lambda path, t: _like(t, saved["::".join(path)]))
        kept = True
        if compressed:
            new_res = rs.state[1]           # the carry's zero residuals
            if residuals is not None:
                stack = self._schedule.res_stack
                want = {key: stack + tuple(v.shape)
                        for key, v in t_res.items()}
                got = {key: tuple(np.shape(v)) for key, v in
                       residuals.items()}
                if got == want:
                    new_res = self._schedule.place_residuals(
                        {key: residuals[key] for key in want})
                else:
                    kept = False
            rs.state = (new_rule, new_res)
        else:
            rs.state = new_rule
        return kept

    def config_fingerprint(self) -> dict:
        """JSON-able identity of this solver, recorded in every elastic
        checkpoint, with the reference's keys.  ``k`` and ``rule`` are
        ENFORCED on resume; the layout fields (schedule, backend, grid,
        compression) are provenance and may change (the remesh path).
        ``rule`` is the reference's string for the same rule: the class's
        module and qualname, then ``cache_key()``'s parameters — a built-in
        rule of the port names the JAX package's module
        (``repro.core.rules``), so the two packages' checkpoints resume in
        each other; a user's own rule names its own module."""
        ck = self._base_rule.cache_key()
        module = _REFERENCE_MODULES.get(ck[0].__module__, ck[0].__module__)
        return {"k": self.k,
                "rule": f"{module}.{ck[0].__qualname__}{ck[1:]!r}",
                "algo": self.algo,
                "schedule": self.schedule, "backend": self.backend,
                "grid": list(self._schedule.grid_shape),
                "panel_compression": self.panel_compression,
                "panel_dtype": (None if self.panel_dtype is None
                                else str(self.panel_dtype))}

    def collect_result(self, rs: RunState) -> NMFResult:
        """Pack a run state into an ``NMFResult``: H back to (k, n), the
        per-segment rel-error history concatenated on the host."""
        W, H = self._schedule.collect(rs.W, rs.Ht)
        rels = (torch.cat(rs.rel_history) if rs.rel_history
                else torch.zeros((0,), dtype=torch.float32))
        rule_state, residuals = self._schedule.split_state(rs.state)
        extras = {"schedule": self.schedule, "backend": self.backend,
                  "device": str(self.device),
                  "grid": self._schedule.grid_shape,
                  "stopped_early": rs.step < self.stopping.max_iters,
                  "rule_state": rule_state}
        if residuals is not None:
            extras["panel_residuals"] = residuals
        return NMFResult(W=W, H=H, rel_errors=rels, algo=self.algo,
                         iters=rs.step, extras=extras)

    # -- one step counted, and the cost model -------------------------------

    def lower_step(self, m: int, n: int, *, dtype=torch.float32,
                   nnz: int | None = None):
        """One iteration of this solver on a global m × n problem (``nnz``
        nonzeros for a sparse backend), run once on fake tensors of this
        rank's blocks and counted: a ``roofline.counts.StepRecord`` of its
        aten ops, matmul FLOPs, bytes, kernel calls and collectives — the
        counterpart of the reference's AOT-lowered HLO.  Nothing is
        allocated on the card and nothing is communicated: the
        collectives are recorded and answered with fake results, so a
        rank may call it alone on any process group.

        BPP's pivoting solve reads its data (``core/bpp.py``) and cannot
        run on fake tensors: its record counts everything around the solve
        and adds the solve's FLOPs from the cost model at one pivot round
        (``record.modelled``).  The accelerated rules run their whole
        inner budget (the stall test has nothing to read)."""
        from repro_torch.roofline.counts import (fake_mode, record_step,
                                                 tensor_bytes)
        self.rule = self._base_rule.prepare_global(m, n, self.k)
        with fake_mode():
            A, W, Ht, normA_sq = self._schedule.abstract_args(m, n, dtype,
                                                              nnz)
            state = self._schedule.init_carry(m, n, dtype)
            with record_step() as rec:
                self._schedule.step(A, W, Ht, normA_sq, state)
            rec.arg_bytes = tensor_bytes((A, W, Ht, state))
        return rec

    def predict_cost(self, m: int, n: int, *, nnz: float = 0.0,
                     bpp_iters: float = 1.0):
        """α-β-γ per-iteration cost prediction for this solver's schedule
        on its grid (faun, gspmd: pr × pc; naive: p × 1), with the
        A-product flops from the backend and the words scaled for
        ``panel_compression`` (``core/costmodel.py``)."""
        from repro_torch.core import costmodel
        pr, pc = self._schedule.grid_shape
        rule = self._base_rule.prepare_global(m, n, self.k)
        return costmodel.schedule_cost(
            self.schedule, m, n, self.k, pr=pr, pc=pc, algo=rule,
            backend=self.ops, nnz=nnz, bpp_iters=bpp_iters,
            compression=self.panel_compression)

    def predict_cost_terms(self, m: int, n: int, *, nnz: float = 0.0,
                           bpp_iters: float = 1.0, machine=None):
        """Per-phase-group predicted seconds (gram / mm / luc / comm /
        error) on ``machine`` (default: ``costmodel.Machine()``)."""
        from repro_torch.core import costmodel
        pr, pc = self._schedule.grid_shape
        rule = self._base_rule.prepare_global(m, n, self.k)
        return costmodel.schedule_cost_terms(
            self.schedule, m, n, self.k, pr=pr, pc=pc, algo=rule,
            backend=self.ops, nnz=nnz, bpp_iters=bpp_iters,
            compression=self.panel_compression, machine=machine)

    # -- loops ---------------------------------------------------------------

    def _step(self, rs: RunState, W, Ht, state):
        Wn, Htn, sq, state = self._schedule.step(rs.A, W, Ht, rs.normA_sq,
                                                 state)
        # Backends emit fp32 from low-precision factors (fp32 accumulation);
        # restore the carry dtype (no-op for fp32 runs).
        return Wn.to(W.dtype), Htn.to(Ht.dtype), sq, state

    def _adaptive_loop(self, rs: RunState, crit: StoppingCriterion) -> None:
        """The reference's while-loop on the host: the stopping test runs in
        fp32 on each iteration's rel error (one sync per iteration).  On a
        grid the rel error comes from all-reduced values only, the same
        bits on every rank, so every rank stops at the same iteration (a
        rank that stopped alone would leave the others waiting in a
        collective)."""
        done, rels = _stopping_test(crit), []
        tracer, seg = active_tracer(), len(rs.rel_history)
        W, Ht, state = rs.W, rs.Ht, rs.state
        for i in range(crit.max_iters):
            with tracer.device_span("phase.iteration", self.device,
                                    iteration=rs.step + i, segment=seg):
                W, Ht, sq, state = self._step(rs, W, Ht, state)
            rels.append(np.float32(_rel_error(sq, rs.normA_sq).item()))
            tracer.resolve()
            if done(rels[-1]):
                break
        rs.W, rs.Ht, rs.state = W, Ht, state
        rs.step += len(rels)
        rs.rel_history.append(torch.tensor(rels, dtype=torch.float32))


#: the reference's module of each of the port's rule modules, named in
#: ``config_fingerprint``'s rule string (a string only: nothing imports it)
_REFERENCE_MODULES = {"repro_torch.core.rules": "repro.core.rules"}


def _flat_leaves(tree):
    """("::"-joined key path, leaf) pairs of a nested container, in the
    checkpoint module's order."""
    from repro_torch.checkpoint.checkpoint import _map_leaves
    out = []
    _map_leaves(tree, lambda path, x: out.append(("::".join(path), x)))
    return out


def _like(template, value):
    """``value`` (an array or number) in the type of ``template``: a tensor
    of its dtype on its device, or the same Python number type."""
    if isinstance(template, torch.Tensor):
        return to_torch(value, device=template.device, dtype=template.dtype)
    return type(template)(np.asarray(value).item())


def _stopping_test(crit: StoppingCriterion):
    """The reference's stopping test, in fp32: a function of each
    iteration's rel error (in order) that says whether to stop after it."""
    f32 = np.float32
    tol = None if crit.tol is None else f32(crit.tol)
    stall_tol = f32(crit.stall_tol)
    best, stall = f32(np.inf), 0

    def done(rel) -> bool:
        nonlocal best, stall
        stall = 0 if rel < best - stall_tol else stall + 1
        best = min(best, rel)
        return bool((tol is not None and rel <= tol)
                    or (crit.stall_iters and stall >= crit.stall_iters))

    return done


def _rel_error(sq: torch.Tensor, normA_sq: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(sq, 0.0) / normA_sq)
