"""Block Principal Pivoting (BPP) solver for nonnegative least squares.

Solves, for each right-hand side b (a row of ``R``):

    min_{x >= 0} || C x - b ||_2

given the precomputed normal-equation matrices ``G = CᵀC`` (k×k) and
``R = (CᵀB)ᵀ`` (r×k, one row per right-hand side), as the paper's
``SolveBPP(CᵀC, CᵀB)`` subroutine (Kim & Park 2011, Algorithm 2).

Counterpart of ``repro/core/bpp.py``, with three differences of form:

* a host loop replaces ``lax.while_loop``: each pivot round gathers the rows
  that are not done yet (one sync) and solves only those.  BPP is
  row-separable and a frozen row never changes again, so the answer is the
  reference's per-row trajectory;
* rows are solved in chunks: at r = 1,013,400 and k = 50 each (r, k, k)
  tensor of the masked normal equations is 10 GB.  Chunking gives the same
  answer for the same reason;
* the passive-set solve uses ``torch.linalg.solve_ex(check_errors=False)``:
  ``torch.linalg.solve`` raises on a singular system, where the reference's
  ``jnp.linalg.solve`` returns non-finite values, and those propagate into
  the result (NaN) exactly as they do in the reference.
"""

from __future__ import annotations

import torch

#: elements of one (rows, k, k) temporary per chunk (a 512 MiB fp32 tensor)
_CHUNK_ELEMS = 1 << 27


def _masked_solve(G: torch.Tensor, passive: torch.Tensor, rhs: torch.Tensor,
                  ridge: float) -> torch.Tensor:
    """Solve G[P,P] x_P = rhs[P] for each row's passive set P.

    A dense masked system so it batches: rows/cols outside P are replaced
    by identity, giving x_i = 0 there.
    """
    pf = passive.to(G.dtype)                            # (r, k)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    M = (G[None] * (pf[:, :, None] * pf[:, None, :])
         + eye[None] * (1.0 - pf)[:, :, None]
         + (ridge * eye)[None] * pf[:, :, None])
    b = rhs * pf
    x = torch.linalg.solve_ex(M, b[..., None], check_errors=False)[0][..., 0]
    return x * pf


def _solve_rows(G: torch.Tensor, R: torch.Tensor, max_iter: int,
                ridge: float) -> torch.Tensor:
    """BPP on one chunk of rows; returns the unclamped primal iterate."""
    r, k = R.shape
    dev = R.device
    x = torch.zeros((r, k), dtype=R.dtype, device=dev)
    y = -R                                              # y = G·0 − r
    passive = torch.zeros((r, k), dtype=torch.bool, device=dev)
    alpha = torch.full((r,), 3, dtype=torch.int32, device=dev)
    beta = torch.full((r,), k + 1, dtype=torch.int32, device=dev)
    done = torch.all(y >= 0, dim=1)                     # already KKT at x = 0
    idx = torch.arange(k, device=dev)[None, :]
    for _ in range(max_iter):
        act = torch.nonzero(~done).squeeze(1)           # the round's one sync
        if act.numel() == 0:
            break
        xa, ya, pa = x[act], y[act], passive[act]
        al, be, Ra = alpha[act], beta[act], R[act]
        V = (pa & (xa < 0)) | (~pa & (ya < 0))          # infeasible set
        ninf = V.sum(dim=1, dtype=torch.int32)
        col_done = ninf == 0

        improved = ninf < be
        use_full = improved | (al > 0)
        new_beta = torch.where(improved, ninf, be)
        new_alpha = torch.where(improved, torch.full_like(al, 3),
                                torch.where(use_full, al - 1, al))

        # Backup rule: flip only the largest infeasible index.
        largest = torch.where(V, idx, -1).amax(dim=1)
        flip = torch.where(use_full[:, None], V, V & (idx == largest[:, None]))

        pn = pa ^ flip
        xn = _masked_solve(G, pn, Ra, ridge)
        yn = xn @ G.T - Ra
        yn = torch.where(pn, torch.zeros_like(yn), yn)
        xn = torch.where(pn, xn, torch.zeros_like(xn))

        # Freeze rows that were already feasible this round.
        keep = col_done[:, None]
        x[act] = torch.where(keep, xa, xn)
        y[act] = torch.where(keep, ya, yn)
        passive[act] = torch.where(keep, pa, pn)
        alpha[act] = torch.where(col_done, al, new_alpha)
        beta[act] = torch.where(col_done, be, new_beta)
        done[act] = col_done
    return x


def solve_bpp(G: torch.Tensor, R: torch.Tensor, *,
              max_iter: int | None = None, ridge: float = 0.0
              ) -> torch.Tensor:
    """Solve min_{X>=0} ||C Xᵀ - B||_F given G = CᵀC and R = (CᵀB)ᵀ.

    Args:
      G: (k, k) Gram matrix CᵀC (symmetric PSD; assumed full rank as in the
        paper's normal-equation formulation).
      R: (r, k) — row i is (Cᵀb_i)ᵀ for right-hand side i.
      max_iter: pivoting iteration cap; default ``5 * k + 10``.
      ridge: optional tiny diagonal regulariser for near-singular passive
        blocks (0.0 = paper-faithful).

    Returns:
      X: (r, k) with X >= 0, KKT-optimal per row (up to fp tolerance); rows
      whose passive system was singular come back non-finite, as in the
      reference.
    """
    r, k = R.shape
    if max_iter is None:
        max_iter = 5 * k + 10
    dtype = torch.promote_types(G.dtype, R.dtype)
    G = G.to(dtype)
    R = R.to(dtype)
    chunk_rows = max(1, _CHUNK_ELEMS // (k * k))
    X = torch.empty((r, k), dtype=dtype, device=R.device)
    for r0 in range(0, r, chunk_rows):
        X[r0:r0 + chunk_rows] = _solve_rows(G, R[r0:r0 + chunk_rows],
                                            max_iter, ridge)
    # Non-terminated rows (pathological / singular G): clamp to feasibility.
    return torch.clamp_min(X, 0.0)
