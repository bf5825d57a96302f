"""Naive-Parallel-AUNMF (paper Algorithm 2; Fairbanks et al.'s scheme) on a
1-D group of p ranks.  Counterpart of ``repro/core/naive.py``.

The communication-inefficient baseline the paper measures against:

  * A is stored TWICE: rank r holds the row block A_r (m/p × n) and the
    column block Aʳ (m × n/p).  With ``backend="sparse"`` each is a 1 × 1
    ``BlockCOO`` sorted only in the orientation its product reads, so even
    this schedule never ships A's nonzeros.  At p = 1 both copies of a
    dense A are views of A itself: no copy is made;
  * each half-iteration all-gathers the ENTIRE fixed factor (O((m+n)k)
    words against FAUN's O(√(mnk²/p)));
  * every rank computes the k×k Gram of the whole factor, redundantly.

Rank r holds rows r·m/p … of W and r·n/p … of Hᵀ.  Under
``panel_compression="int8"`` the two full-factor gathers — the schedule's
only panel collectives — move int8 payloads with error feedback
(``distributed.compression``); each rank carries its own two residuals
(``init_naive_residuals``).
"""

from __future__ import annotations

import torch

from repro_torch.core import rules as _rules
from repro_torch.core.faun import all_reduce, allgather_panel, gram_allreduce


def naive_iteration(Arow, Acol, W_blk, Ht_blk, normA_sq, state, *, group,
                    rule, ops, compress=None):
    """One iteration of Algorithm 2 on this rank's blocks.

    Arow: (m/p, n)   row block of A       W_blk:  (m/p, k)
    Acol: (m, n/p)   column block of A    Ht_blk: (n/p, k)

    Under ``compress`` the carry is ``(rule_state, residuals)``.  Returns
    (W_blk, Ht_blk, sq_err, state); sq_err and the rule state are the same
    on every rank.
    """
    res = None
    if compress is not None:
        state, res = state          # residuals updated in place (faun's)

    def norm_psum(v):
        return all_reduce(v, group)

    def panel_allgather(x, key):
        if compress is None:
            return allgather_panel(x, group)
        y, res[key] = compress.all_gather(x, group, res[key])
        return y

    # --- W given H: all-gather the whole of H, redundant Gram (lines 3-4) ---
    Ht = panel_allgather(Ht_blk, "gather_h")                  # (n, k)
    HHt = ops.gram(Ht)
    AHt_blk = ops.mm(Arow, Ht)                                # (m/p, k)
    del Ht
    W_blk, state = rule.update_w(HHt, AHt_blk, W_blk, state,
                                 norm_psum=norm_psum)
    del AHt_blk             # freed before the whole of W is gathered

    # --- H given W: all-gather the whole of W, redundant Gram (lines 5-6) ---
    W = panel_allgather(W_blk, "gather_w")                    # (m, k)
    WtW = ops.gram(W)
    WtA_t_blk = ops.mm_t(Acol, W)                             # (n/p, k)
    del W
    Ht_blk, state = rule.update_h(WtW, WtA_t_blk, Ht_blk, state,
                                  norm_psum=norm_psum)

    # --- error from byproducts ---
    HHt_new = gram_allreduce(Ht_blk, group, gram=ops.gram)
    cross = all_reduce((WtA_t_blk.float() * Ht_blk.float()).sum(), group)
    quad = (WtW.float() * HHt_new.float()).sum()
    sq_err = normA_sq - 2.0 * cross + quad
    if compress is not None:
        state = (state, res)
    return W_blk, Ht_blk, sq_err, state


def init_naive_residuals(p: int, m: int, n: int, k: int, *, device=None):
    """Zero error-feedback residuals of this rank's two factor gathers
    (the reference's leaves without their leading mesh dimension)."""
    return {"gather_h": torch.zeros((n // p, k), dtype=torch.float32,
                                    device=device),
            "gather_w": torch.zeros((m // p, k), dtype=torch.float32,
                                    device=device)}


def fit(A, k: int, *, group=None, algo="bpp", iters: int = 30,
        seed: int | None = None, H0=None, W0=None, backend=None,
        device=None, panel_compression: str | None = None):
    """Thin wrapper over ``core.engine.NMFSolver(schedule="naive")`` on
    ``group`` (None: the default process group); every rank calls it with
    the same global A.  ``backend=None`` takes "sparse" for sparse input
    and the CUDA kernels ("cuda") otherwise."""
    from repro_torch.backends import infer_backend
    from repro_torch.core.engine import NMFSolver
    if backend is None:
        backend = "sparse" if infer_backend(A) == "sparse" else "cuda"
    solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="naive",
                       backend=backend, group=group, device=device,
                       max_iters=iters, panel_compression=panel_compression)
    return solver.fit(A, seed=seed, H0=H0, W0=W0)


def lower_step(group, m: int, n: int, k: int, *, algo="bpp",
               dtype=torch.float32, backend="dense", nnz: int | None = None,
               device=None):
    """One Naive iteration on ``group`` (None: the default process group)
    for a global m × n problem, counted on fake tensors of this rank's
    blocks (``NMFSolver.lower_step``)."""
    from repro_torch.core.engine import NMFSolver
    from repro_torch.roofline.counts import stand_in_card
    with stand_in_card():
        solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="naive",
                           backend=backend, group=group, device=device)
        return solver.lower_step(m, n, dtype=dtype, nnz=nnz)
