"""Update rules as plugins: the ``UpdateRule`` interface and the algorithm
registry.  Counterpart of ``repro/core/rules.py``.

Both half-updates use a single "row-factor" convention (paper §4):

    X ∈ R_+^{r×k}  (rows of W, or columns of H transposed)
    G ∈ R^{k×k}    (Gram of the *fixed* factor: HHᵀ or WᵀW)
    R ∈ R^{r×k}    (cross product block: (AHᵀ) rows, or (WᵀA)ᵀ rows)

so one rule works unchanged for the W-step and the H-step.

Built-in rules (resolved by name through the registry): ``mu`` (Lee &
Seung, paper §4.1), ``hals`` (Cichocki et al., §4.2) and ``bpp`` (exact ANLS
by block principal pivoting, §4.3; aliases ``abpp`` / ``anls``).  The
accelerated rules (``amu`` / ``ahals``), ``partial_update_h`` and
``fold_in`` of the reference are not ported yet.

    from repro_torch.core.rules import UpdateRule, register_algorithm

    class MyRule(UpdateRule):
        name = "mine"
        def _update_w(self, G, R, X, state, *, norm_psum): ...
        def _update_h(self, G, R, X, state, *, norm_psum): ...

    register_algorithm("mine", MyRule)
    NMFSolver(k, algo="mine")            # or algo=MyRule()
"""

from __future__ import annotations

import math
from typing import Callable, Type, Union

import torch

from repro_torch.core.bpp import solve_bpp


def eps_for(dtype: torch.dtype) -> float:
    """Division-guard epsilon that survives ``dtype``'s exponent range:
    ``sqrt(tiny)`` sits halfway down the exponent range of every IEEE
    format (fp32/bf16: ≈1.1e-19; fp16: ≈7.8e-3)."""
    return math.sqrt(float(torch.finfo(dtype).tiny))


def _identity(v):
    return v


# ---------------------------------------------------------------------------
# The primitive update computations (LUC bodies)
# ---------------------------------------------------------------------------

def update_mu(G: torch.Tensor, R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X ← X ⊙ R / (X G + ε)   (paper eq. (3); F = 2rk² flops)."""
    denom = X @ G + eps_for(X.dtype)
    return X * (R / denom)


def update_hals(G: torch.Tensor, R: torch.Tensor, X: torch.Tensor, *,
                normalize: bool = False,
                norm_psum: Callable[[torch.Tensor], torch.Tensor] = _identity,
                ) -> torch.Tensor:
    """Sequential HALS column sweep (paper eq. (5); F = 2rk² flops).

    W-step (normalize=True):   w^i ← [w^i·G_ii + R^i − X G^i]_+ ;  w^i ← w^i/‖w^i‖
    H-step (normalize=False):  h_i ← [h_i + (R^i − X G^i)/G_ii]_+

    Columns are updated in order so later columns see earlier updates.
    ``norm_psum`` threads the W-step's per-column norm reduction (identity
    when serial).  Returns a new contiguous tensor; X is not modified.
    """
    k = G.shape[0]
    eps = eps_for(X.dtype)
    X = X.clone(memory_format=torch.contiguous_format)
    for i in range(k):
        gii = G[i, i]
        if normalize:
            xi = X[:, i] * gii + R[:, i] - X @ G[:, i]
            xi = torch.clamp_min(xi, 0.0)
            sq = norm_psum(torch.sum(torch.square(xi.float())))
            nrm = torch.sqrt(sq).to(xi.dtype)
            # Guard the all-zero column (paper's code resets to machine eps).
            xi = torch.where(nrm > 0, xi / torch.clamp_min(nrm, eps), xi)
        else:
            xi = X[:, i] + (R[:, i] - X @ G[:, i]) / torch.clamp_min(gii, eps)
            xi = torch.clamp_min(xi, 0.0)
        X[:, i] = xi.to(X.dtype)
    return X


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

        update_w(G, R, X, state=None, *, norm_psum=identity) -> (X, state)

    ``state`` is the rule's carry (``init_state``'s output, or None for
    stateless rules), threaded by the engine's loop.
    """

    #: registry key and the ``NMFSolver(...).algo`` string
    name: str = "abstract"

    #: MU-family rules are multiplicative — W must start strictly positive
    positive_init: bool = False

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

    def update_w(self, G, R, X, state=None, *, norm_psum=_identity):
        G, R = self.regularize(G, R)
        return self._update_w(G, R, X, state, norm_psum=norm_psum)

    def update_h(self, G, R, X, state=None, *, norm_psum=_identity):
        G, R = self.regularize(G, R)
        return self._update_h(G, R, X, state, norm_psum=norm_psum)

    def _update_w(self, G, R, X, state, *, norm_psum):
        raise NotImplementedError

    def _update_h(self, G, R, X, state, *, norm_psum):
        raise NotImplementedError

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


class HALSRule(UpdateRule):
    """Cichocki et al. hierarchical ALS (paper §4.2).  The W-step
    normalises each column right after updating it; the H-step never
    does."""

    name = "hals"

    def _update_w(self, G, R, X, state, *, norm_psum):
        return update_hals(G, R, X, normalize=True,
                           norm_psum=norm_psum), state

    def _update_h(self, G, R, X, state, *, norm_psum):
        return update_hals(G, R, X, normalize=False), state


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
