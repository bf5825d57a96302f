"""Functional compatibility layer over the update-rule plugin API.
Counterpart of ``repro/core/algorithms.py``.

The algorithm surface lives in ``repro_torch.core.rules``: the
``UpdateRule`` interface, the ``register_algorithm`` registry, and the
built-in rules (``mu``, ``hals``, ``bpp``/``abpp``/``anls``, and the
Gillis–Glineur accelerated ``amu``/``ahals`` — plus anything a project
registers).  This module re-exports the primitive update computations and
keeps the two closure-style helpers older call sites use:

  * ``get_update_fns(algo)``  → stateless ``(G, R, X) -> X`` closures
  * ``make_fold_in(algo)``    → a serving fold closure

Both resolve through the registry, so any registered rule — by name or as
an ``UpdateRule`` instance — works here too.

HALS normalisation: the paper normalises each column of W right after
updating it (the H half-update has no normalisation).  On a grid the column
norm is a global reduction, which the paper charges as the extra
``k·log p`` latency of HALS; the rules thread a ``norm_psum`` callable for
it (identity when serial, an all-reduce over the grid when distributed).
"""

from __future__ import annotations

from typing import Callable

# Re-exported primitives (single numeric implementation, in rules.py).
from repro_torch.core.rules import (eps_for, update_bpp,  # noqa: F401
                                    update_hals, update_mu)
from repro_torch.core import rules as _rules

#: name -> primitive LUC callable, for quick functional access; the full
#: open set (accelerated and custom rules too) lives in the registry:
#: ``rules.available_algorithms()``.
ALGORITHMS: dict[str, Callable] = {
    "mu": update_mu,
    "hals": update_hals,
    "bpp": update_bpp,
}


def make_fold_in(algo: "_rules.RuleSpec", *, iters: int = 100,
                 max_iter: int | None = None) -> Callable:
    """Return ``fold(G, R, X0=None) -> X`` projecting rows onto a FIXED
    factor — ``rules.get_rule(algo).fold_in`` as a closure.

    Serving fold-in is one half-update of AU-NMF with the trained factor
    held fixed — the paper's ``SolveBPP(HHᵀ, HAᵀ_new)`` applied to unseen
    rows.  Exact rules (BPP) solve in one call; iterative rules run up to
    ``iters`` sweeps (the accelerated family stops early on its stall
    criterion).  ``max_iter`` bounds BPP's pivot rounds.
    """
    rule = _rules.get_rule(algo)
    # Exact-type check: a BPPRule SUBCLASS carries its own configuration
    # and overrides — rebuild only the plain built-in, never a subclass.
    if max_iter is not None and type(rule) is _rules.BPPRule:
        rule = _rules.BPPRule(max_iter=max_iter, l1=rule.l1, l2=rule.l2)

    def fold(G, R, X0=None):
        return rule.fold_in(G, R, X0, iters=iters)

    return fold


def get_update_fns(algo: "_rules.RuleSpec", *, norm_psum=None):
    """Returns stateless ``(update_w, update_h)`` closures for ``algo``.

    update_w normalises columns under the HALS family (the paper's
    convention); update_h never does.  Both have signature (G, R, X) ->
    X_new with X, R of shape (rows, k).  Rule state is dropped — schedules
    that want the carry call the rule's ``update_w``/``update_h``
    directly, as ``core.engine`` does.
    """
    rule = _rules.get_rule(algo)

    def update_w(G, R, X):
        return rule.update_w(G, R, X, None, norm_psum=norm_psum)[0]

    def update_h(G, R, X):
        return rule.update_h(G, R, X, None, norm_psum=norm_psum)[0]

    return update_w, update_h
