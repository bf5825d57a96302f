"""Update rules as plugins: the ``UpdateRule`` interface and the algorithm
registry.  Counterpart of ``repro/core/rules.py``.

Both half-updates use a single "row-factor" convention (paper §4):

    X ∈ R_+^{r×k}  (rows of W, or columns of H transposed)
    G ∈ R^{k×k}    (Gram of the *fixed* factor: HHᵀ or WᵀW)
    R ∈ R^{r×k}    (cross product block: (AHᵀ) rows, or (WᵀA)ᵀ rows)

so one rule works unchanged for the W-step and the H-step.

Beside the two half-updates, a rule serves ``fold_in(G, R, X0)`` (the
serving half-update against a FIXED factor, ``repro_torch.serve.foldin``)
and ``partial_update_h(G, R, X, mask, state)`` (a touched-row H refresh).

Built-in rules (resolved by name through the registry): ``mu`` (Lee &
Seung, paper §4.1), ``hals`` (Cichocki et al., §4.2), ``bpp`` (exact ANLS
by block principal pivoting, §4.3; aliases ``abpp`` / ``anls``), and
``amu`` / ``ahals`` (Gillis & Glineur's accelerated MU / HALS,
arXiv:1107.5194: repeated inner sweeps per (G, R)).  Each rule carries the
reference's cost hooks for ``core/costmodel.py``:

    luc_flops(m, n, k)         F(m, n, k) of the paper's Table III
    extra_latency_words(k, p)  (messages, wire words) of any collectives the
                               rule itself performs (HALS's column norms)

``cache_key()`` is the rule's identity: the class and its parameters, in
the reference's fields and order.  The port has no compiled-run cache; the
engine's ``config_fingerprint`` names the rule by it, and the elastic
runtime refuses to resume a checkpoint under another one.

The MU update and the HALS sweeps run through the hand-written LUC kernels
(``kernels.ops.mu_update`` / ``hals_sweep``, and for a W-step on one device
``hals_sweep_norm``) with ε = ``eps_for(X.dtype)``; on CPU tensors their
plain versions (``kernels/ref.py``).

    from repro_torch.core.rules import UpdateRule, register_algorithm

    class MyRule(UpdateRule):
        name = "mine"
        def _update_w(self, G, R, X, state, *, norm_psum): ...
        def _update_h(self, G, R, X, state, *, norm_psum): ...

    register_algorithm("mine", MyRule)
    NMFSolver(k, algo="mine")            # or algo=MyRule()
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Type, Union

import torch

from repro_torch.core.bpp import solve_bpp
from repro_torch.kernels import ops, ref


def eps_for(dtype: torch.dtype) -> float:
    """Division-guard epsilon that survives ``dtype``'s exponent range:
    ``sqrt(tiny)`` sits halfway down the exponent range of every IEEE
    format (fp32/bf16: ≈1.1e-19; fp16: ≈7.8e-3)."""
    return math.sqrt(float(torch.finfo(dtype).tiny))


# ---------------------------------------------------------------------------
# The primitive update computations (LUC bodies)
# ---------------------------------------------------------------------------

def update_mu(G: torch.Tensor, R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X ← X ⊙ R / (X G + ε)   (paper eq. (3); F = 2rk² flops), in X's
    dtype, through the ``mu_update`` kernel."""
    return ops.mu_update(X.contiguous(), G.contiguous(), R.contiguous(),
                         eps=eps_for(X.dtype))


def update_hals(G: torch.Tensor, R: torch.Tensor, X: torch.Tensor, *,
                normalize: bool = False,
                norm_psum: Callable | None = None) -> torch.Tensor:
    """Sequential HALS column sweep (paper eq. (5); F = 2rk² flops).

    W-step (normalize=True):   w^i ← [w^i·G_ii + R^i − X G^i]_+ ;  w^i ← w^i/‖w^i‖
    H-step (normalize=False):  h_i ← [h_i + (R^i − X G^i)/G_ii]_+

    Columns are updated in order so later columns see earlier updates.
    The H-step runs through the ``hals_sweep`` kernel.  ``norm_psum``
    threads the W-step's per-column norm reduction over the ranks that
    hold the other rows (None: every row is here).  Returns a new
    contiguous tensor in X's dtype; X is not modified.
    """
    eps = eps_for(X.dtype)
    X, G, R = X.contiguous(), G.contiguous(), R.contiguous()
    if not normalize:
        return ops.hals_sweep(X, G, R, eps=eps)
    # The W-step: column i's norm is a reduction over ALL rows that must
    # finish before column i + 1 starts.  With every row on one device the
    # hals_sweep_norm kernel keeps that order on the device; a reduction
    # over ranks (a collective a column) runs the plain loop.
    if norm_psum is None:
        return ops.hals_sweep_norm(X, G, R, eps=eps)
    return ref.hals_sweep_norm(X, G, R, eps, norm_psum)


def update_bpp(G: torch.Tensor, R: torch.Tensor, X: torch.Tensor, *,
               max_iter: int | None = None) -> torch.Tensor:
    """Exact NLS via block principal pivoting; X is only a shape hint."""
    del X  # BPP re-solves from scratch (ANLS is memoryless per half-update)
    return solve_bpp(G, R, max_iter=max_iter)


# ---------------------------------------------------------------------------
# The UpdateRule interface
# ---------------------------------------------------------------------------

class UpdateRule:
    """Abstract update rule.  Subclass and implement ``_update_w`` /
    ``_update_h``; everything else defaults sensibly.

    The public ``update_w`` / ``update_h`` are template methods: they apply
    the rule's regularisation to (G, R), then dispatch to the ``_update_*``
    hooks:

        update_w(G, R, X, state=None, *, norm_psum=None) -> (X, state)

    ``norm_psum`` sums a rank's partial reductions (HALS's column norms,
    the accelerated rules' change norms) over the ranks that hold the
    other rows; None where one device holds them all.

    ``state`` is the rule's carry (``init_state``'s output, or None for
    stateless rules), threaded by the engine's loop.
    """

    #: registry key and the ``NMFSolver(...).algo`` string
    name: str = "abstract"

    #: MU-family rules are multiplicative — W must start strictly positive
    positive_init: bool = False

    #: whether ``update_w`` performs per-column norm reductions over the
    #: grid (the HALS family)
    normalizes_w: bool = False

    def __init__(self, *, l1: float = 0.0, l2: float = 0.0):
        if l1 < 0 or l2 < 0:
            raise ValueError(f"regularisation weights must be >= 0, got "
                             f"l1={l1}, l2={l2}")
        self.l1, self.l2 = float(l1), float(l2)

    # -- regularisation ------------------------------------------------------

    def regularize(self, G, R):
        """Fold L2 (ridge) and L1 (sparsity) penalties into the normal-
        equation pair: G ← G + l2·I and R ← R − l1."""
        if self.l2:
            G = G + self.l2 * torch.eye(G.shape[0], dtype=G.dtype,
                                        device=G.device)
        if self.l1:
            R = R - self.l1
        return G, R

    # -- state ---------------------------------------------------------------

    def init_state(self, m: int, n: int, k: int, dtype=torch.float32):
        """Carry threaded through the engine loop (None = stateless).
        ``m``/``n``/``k`` are the GLOBAL problem dimensions."""
        del m, n, k, dtype
        return None

    def prepare_global(self, m: int, n: int, k: int) -> "UpdateRule":
        """Hook called once per fit with the GLOBAL problem dimensions;
        return ``self`` or a configured clone."""
        del m, n, k
        return self

    # -- the two half-updates ------------------------------------------------

    def update_w(self, G, R, X, state=None, *, norm_psum=None):
        G, R = self.regularize(G, R)
        return self._update_w(G, R, X, state, norm_psum=norm_psum)

    def update_h(self, G, R, X, state=None, *, norm_psum=None):
        G, R = self.regularize(G, R)
        return self._update_h(G, R, X, state, norm_psum=norm_psum)

    def _update_w(self, G, R, X, state, *, norm_psum):
        raise NotImplementedError

    def _update_h(self, G, R, X, state, *, norm_psum):
        raise NotImplementedError

    # -- partial (touched-block) refresh -------------------------------------

    def partial_update_h(self, G, R, X, mask=None, state=None, *,
                         norm_psum=None):
        """Touched-block H refresh (Gao & Chu, arXiv:1802.08938): update
        only the rows of X selected by the boolean ``mask`` (r,), returning
        the others as they came in.  The default runs a FULL ``update_h``
        and merges on ``mask``.  Every built-in H half-update is
        row-separable, so a caller holding a gather of the touched rows may
        pass it with ``mask=None`` instead."""
        Xn, state = self.update_h(G, R, X, state, norm_psum=norm_psum)
        if mask is None:
            return Xn, state
        return torch.where(mask[:, None], Xn, X), state

    # -- serving fold-in -----------------------------------------------------

    def _fold_setup(self, G, R, X0):
        """(X0, sweep) for iterative fold-in; exact solvers skip this by
        overriding ``fold_in`` directly."""
        raise NotImplementedError

    def fold_in(self, G, R, X0=None, *, iters: int = 100):
        """Project rows onto a FIXED factor: x_i = argmin_{x≥0} ‖a_i − xH‖
        given G = HHᵀ and R = A_new Hᵀ — the paper's ``SolveBPP(HHᵀ, HAᵀ)``
        serving half-update.  Iterative rules run ``iters`` sweeps."""
        G, R = self.regularize(G, R)
        X, sweep = self._fold_setup(G, R, X0)
        for _ in range(iters):
            X = sweep(X)
        return X

    # -- cost hooks (paper Table III) ---------------------------------------

    def luc_flops(self, m: float, n: float, k: float, *,
                  bpp_iters: float = 1.0) -> float:
        """F(m, n, k): flops of the two local update computations per
        iteration.  ``bpp_iters`` is the empirical pivot-round knob only the
        BPP family consumes (the paper leaves C_BPP symbolic)."""
        del bpp_iters
        return 2.0 * (m + n) * k * k

    def extra_latency_words(self, k: float, p: int) -> tuple[float, float]:
        """(messages, wire words) per iteration of any collectives the RULE
        itself performs beyond the schedule's matrix-product collectives.
        The HALS family's per-column norm all-reduces are the paper's
        example: k messages of log p latency each, one scalar of wire."""
        if p <= 1 or not self.normalizes_w:
            return 0.0, 0.0
        return k * math.log2(p), 2.0 * k * (p - 1) / p

    def cache_key(self):
        """Hashable identity: the concrete class object, then the
        parameters that change what the rule computes (the reference's
        fields, in its order).  Stateful configuration must extend it."""
        return (type(self), self.name, self.l1, self.l2)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


# ---------------------------------------------------------------------------
# Built-in rules
# ---------------------------------------------------------------------------

class MURule(UpdateRule):
    """Lee & Seung multiplicative update (paper §4.1)."""

    name = "mu"
    positive_init = True

    def regularize(self, G, R):
        G, R = super().regularize(G, R)
        if self.l1:
            # Multiplicative rules need a nonnegative numerator.
            R = torch.clamp_min(R, 0.0)
        return G, R

    def _update_w(self, G, R, X, state, *, norm_psum):
        return update_mu(G, R, X), state

    _update_h = _update_w

    def _fold_setup(self, G, R, X0):
        # The multiplicative rule is only defined for positive iterates:
        # start from a strictly positive Jacobi init (R_i / G_ii).  Zero
        # (padding) rows start at ε and fall to 0 in the first sweep.
        Rp = torch.clamp_min(R, 0.0)
        if X0 is None:
            eps = eps_for(R.dtype)
            d = torch.clamp_min(torch.diagonal(G), eps)
            X0 = torch.clamp_min(Rp / d, eps)
        return X0, lambda X: update_mu(G, Rp, X)


class HALSRule(UpdateRule):
    """Cichocki et al. hierarchical ALS (paper §4.2).  The W-step
    normalises each column right after updating it; the H-step never
    does."""

    name = "hals"
    normalizes_w = True

    def _update_w(self, G, R, X, state, *, norm_psum):
        return update_hals(G, R, X, normalize=True,
                           norm_psum=norm_psum), state

    def _update_h(self, G, R, X, state, *, norm_psum):
        return update_hals(G, R, X, normalize=False), state

    def _fold_setup(self, G, R, X0):
        X0 = torch.zeros_like(R) if X0 is None else X0
        return X0, lambda X: update_hals(G, R, X, normalize=False)


class BPPRule(UpdateRule):
    """Exact ANLS via block principal pivoting (paper §4.3, core/bpp.py).
    ``max_iter`` bounds the pivot rounds (None = the solver default)."""

    name = "bpp"

    def __init__(self, *, max_iter: int | None = None,
                 l1: float = 0.0, l2: float = 0.0):
        super().__init__(l1=l1, l2=l2)
        self.max_iter = max_iter

    def _update_w(self, G, R, X, state, *, norm_psum):
        return update_bpp(G, R, X, max_iter=self.max_iter), state

    _update_h = _update_w

    def fold_in(self, G, R, X0=None, *, iters: int = 100):
        del X0, iters               # exact solve, no warm start needed
        G, R = self.regularize(G, R)
        return solve_bpp(G, R, max_iter=self.max_iter)

    def luc_flops(self, m, n, k, *, bpp_iters: float = 1.0):
        # `bpp_iters` passes of a k×k solve per column: ~k³/3 + 2k² flops
        # per column per pivot round (empirically 1–3 rounds dominate).
        per_col = bpp_iters * (k ** 3 / 3.0 + 2.0 * k * k)
        return (m + n) * per_col

    def cache_key(self):
        return super().cache_key() + (self.max_iter,)


def _not_stalled(d: torch.Tensor, threshold: torch.Tensor) -> bool:
    """The accelerated rules' stall test, read back to the host.  On fake
    tensors (``lower_step``, the dry run) there is nothing to read: the
    loop runs its whole budget, the worst case ``luc_flops`` prices."""
    from repro_torch.roofline.counts import is_fake
    if is_fake(d):
        return True
    return bool(d > threshold)


class _AcceleratedRule(UpdateRule):
    """Gillis & Glineur acceleration (arXiv:1107.5194), shared machinery.

    The matrix products cost O(mnk) per iteration while one MU/HALS LUC
    sweep costs O((m+n)k²), so the cheap sweep repeats up to
    ``inner_iters`` times on the SAME (G, R), stopping early once the inner
    progress stalls:

        stop after sweep l when ‖X^(l+1) − X^(l)‖_F ≤ delta · ‖X^(2) − X^(1)‖_F

    ``delta=0.0`` disables the early stop: exactly ``inner_iters`` sweeps
    and no change norms; ``delta>=1`` stops right after the mandatory first
    sweep that sets the baseline.  The carried state counts the inner sweeps
    run per half (``inner_w`` / ``inner_h``, host integers), surfaced after
    a fit in ``NMFResult.extras["rule_state"]``.  Serving fold-in uses the
    same machinery with the tighter ``fold_delta``.  At ``inner_iters=1``
    the accelerated rules equal their plain counterparts.

    ``inner_iters=None`` derives each half's budget from the problem size
    in ``prepare_global`` (their §3.2): ``1 + ⌊α·ρ⌋`` sweeps with
    ρ_W = 1 + (mn + nk)/(mk + m) (ρ_H swaps m ↔ n) and the rule's
    ``accel_alpha`` (2.0 for MU, 0.5 for HALS).
    """

    #: Gillis–Glineur α of the derived inner budget 1 + ⌊α·ρ⌋
    accel_alpha: float = 2.0

    def __init__(self, *, inner_iters: int | None = 4, delta: float = 0.01,
                 fold_delta: float = 1e-6, l1: float = 0.0, l2: float = 0.0):
        super().__init__(l1=l1, l2=l2)
        if inner_iters is not None and inner_iters < 1:
            raise ValueError(f"inner_iters must be >= 1 or None (derive the "
                             f"Gillis–Glineur budget), got {inner_iters}")
        if delta < 0 or fold_delta < 0:
            raise ValueError(f"delta must be >= 0, got {delta}/{fold_delta}")
        self.inner_iters = None if inner_iters is None else int(inner_iters)
        self.delta = float(delta)
        self.fold_delta = float(fold_delta)
        # Per-half sweep budgets; None resolves in prepare_global.
        self._budget_w = self._budget_h = self.inner_iters

    def _derived_budget(self, rows: int, cols: int, k: int) -> int:
        rho = 1.0 + (rows * cols + cols * k) / (rows * k + rows)
        return 1 + int(self.accel_alpha * rho)

    def prepare_global(self, m, n, k):
        if self.inner_iters is not None:
            return self
        rule = copy.copy(self)
        rule._budget_w = self._derived_budget(m, n, k)
        rule._budget_h = self._derived_budget(n, m, k)
        return rule

    def _budgets(self) -> tuple[int, int]:
        if self._budget_w is None:
            raise RuntimeError(
                f"{self.name}: inner_iters=None derives the sweep budget "
                f"from the global problem size; call prepare_global(m, n, k) "
                f"first (NMFSolver does this at fit time)")
        return self._budget_w, self._budget_h

    def init_state(self, m, n, k, dtype=torch.float32):
        del m, n, k, dtype
        return {"inner_w": 0, "inner_h": 0}

    def _accelerate(self, sweep, X, norm_psum, *, budget: int, delta: float):
        """Run up to ``budget`` sweeps with the stall criterion; returns
        (X, sweeps run)."""
        X1 = sweep(X)
        if budget <= 1:
            return X1, 1
        if delta == 0.0:
            for _ in range(1, budget):
                X1 = sweep(X1)
            return X1, budget

        def change(Xn, X):
            d = torch.sum(torch.square((Xn - X).float()))
            return torch.sqrt(d if norm_psum is None else norm_psum(d))

        d0 = change(X1, X)
        X, d, sweeps = X1, d0, 1
        # The stall test reads the change norm back to the host: one sync
        # per inner sweep (the reference tests it on the device inside a
        # while_loop).  delta = 0 takes the fixed loop above, with no sync.
        # On a grid d and d0 come through norm_psum (all-reduced), so every
        # rank runs the same number of sweeps.
        while sweeps < budget and _not_stalled(d, delta * d0):
            Xn = sweep(X)
            d = change(Xn, X)
            X, sweeps = Xn, sweeps + 1
        return X, sweeps

    def _count(self, state, key, sweeps):
        if state is None:           # stateless callers
            return None
        return {**state, key: state[key] + sweeps}

    def _update_w(self, G, R, X, state, *, norm_psum):
        X, sweeps = self._accelerate(
            lambda X: self._sweep_w(G, R, X, norm_psum), X, norm_psum,
            budget=self._budgets()[0], delta=self.delta)
        return X, self._count(state, "inner_w", sweeps)

    def _update_h(self, G, R, X, state, *, norm_psum):
        X, sweeps = self._accelerate(
            lambda X: self._sweep_h(G, R, X, norm_psum), X, norm_psum,
            budget=self._budgets()[1], delta=self.delta)
        return X, self._count(state, "inner_h", sweeps)

    def fold_in(self, G, R, X0=None, *, iters: int = 100):
        # Up to ``iters`` sweeps with an early exit at fold_delta; a request
        # batch lives on one device, so the change norms need no reduction.
        G, R = self.regularize(G, R)
        X, sweep = self._fold_setup(G, R, X0)
        X, _ = self._accelerate(sweep, X, None, budget=max(iters, 1),
                                delta=self.fold_delta)
        return X

    def luc_flops(self, m, n, k, *, bpp_iters: float = 1.0):
        # Budgeted (worst-case) flops: the early stop can only spend less.
        del bpp_iters
        bw, bh = self._budgets()
        return bw * 2.0 * m * k * k + bh * 2.0 * n * k * k

    def extra_latency_words(self, k, p):
        if p <= 1:
            return 0.0, 0.0
        # The base rule's per-sweep reductions (HALS: k column norms, a
        # W-step property) are paid on every inner W sweep; the stall-norm
        # all-reduce (one scalar per sweep, both halves) exists only when
        # the stall exit is live (a budget above 1 and delta > 0).
        bw, bh = self._budgets()
        base_m, base_w = super().extra_latency_words(k, p)
        msgs, words = bw * base_m, bw * base_w
        if max(bw, bh) > 1 and self.delta > 0.0:
            msgs += (bw + bh) / 2.0 * math.log2(p)
            words += (bw + bh) * (p - 1) / p
        return msgs, words

    def cache_key(self):
        return super().cache_key() + (self.inner_iters, self.delta,
                                      self.fold_delta, self._budget_w,
                                      self._budget_h)


class AcceleratedMURule(_AcceleratedRule, MURule):
    """Gillis & Glineur accelerated MU: repeated multiplicative sweeps per
    (G, R) with the inner stall criterion."""

    name = "amu"
    accel_alpha = 2.0

    def _sweep_w(self, G, R, X, norm_psum):
        return update_mu(G, R, X)

    _sweep_h = _sweep_w


class AcceleratedHALSRule(_AcceleratedRule, HALSRule):
    """Gillis & Glineur accelerated HALS: repeated column sweeps per (G, R)
    with the inner stall criterion (the W-step keeps the paper's
    per-column normalisation on every sweep)."""

    name = "ahals"
    accel_alpha = 0.5

    def _sweep_w(self, G, R, X, norm_psum):
        return update_hals(G, R, X, normalize=True, norm_psum=norm_psum)

    def _sweep_h(self, G, R, X, norm_psum):
        return update_hals(G, R, X, normalize=False)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RuleSpec = Union[str, UpdateRule, Type[UpdateRule]]

_REGISTRY: dict[str, Callable[[], UpdateRule]] = {}


def register_algorithm(name: str, factory: Callable[[], UpdateRule],
                       *, overwrite: bool = False) -> None:
    """Register an ``UpdateRule`` factory (a class or zero-arg callable)
    under ``name`` so ``NMFSolver(algo=name)`` finds it."""
    name = name.lower()
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"algorithm {name!r} is already registered; pass "
                         f"overwrite=True to replace it")
    _REGISTRY[name] = factory


def available_algorithms() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_rule(spec: RuleSpec) -> UpdateRule:
    """Resolve an algorithm name / instance / class to an ``UpdateRule``."""
    if isinstance(spec, UpdateRule):
        return spec
    if isinstance(spec, type) and issubclass(spec, UpdateRule):
        return spec()
    if isinstance(spec, str):
        try:
            factory = _REGISTRY[spec.lower()]
        except KeyError:
            raise ValueError(
                f"unknown NMF algorithm {spec!r}; choose from "
                f"{available_algorithms()} or register_algorithm() your own"
            ) from None
        return factory()
    raise TypeError(f"algo must be a name, UpdateRule instance, or "
                    f"UpdateRule subclass; got {type(spec).__name__}")


register_algorithm("mu", MURule)
register_algorithm("hals", HALSRule)
register_algorithm("bpp", BPPRule)
register_algorithm("abpp", BPPRule)        # the paper's name for ANLS-BPP
register_algorithm("anls", BPPRule)
register_algorithm("amu", AcceleratedMURule)
register_algorithm("ahals", AcceleratedHALSRule)
