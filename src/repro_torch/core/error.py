"""Relative-error computation for NMF via the trace trick (paper §6.2).

relative_error = ||A − WH||_F / ||A||_F, expanded as

    ||A − WH||² = ||A||² − 2·tr(Wᵀ A Hᵀ) + tr((WᵀW)(HHᵀ))

so it never materialises WH (m×n) and reuses the iteration's byproducts:
tr(WᵀA·Hᵀ) = Σ (WᵀA ⊙ H) and the two k×k Grams.  ||A||² is computed once.

Counterpart of ``repro/core/error.py``.
"""

from __future__ import annotations

import torch

#: elements per chunk of ``sq_frobenius`` (a 256 MiB fp32 temporary)
_CHUNK_ELEMS = 1 << 26


def sq_frobenius(A: torch.Tensor) -> torch.Tensor:
    """||A||_F² as an fp32 scalar tensor on A's device.

    Reduced in row chunks: ``A32 * A32`` over the whole of a 56 GB A would
    be another 56 GB.  Chunk sums are added in float64.
    """
    rows = max(1, _CHUNK_ELEMS // max(1, A.shape[-1]))
    total = torch.zeros((), dtype=torch.float64, device=A.device)
    for r0 in range(0, A.shape[0], rows):
        blk = A[r0:r0 + rows].float()
        total += (blk * blk).sum(dtype=torch.float64)
    return total.float()


def sq_error_from_products(normA_sq: torch.Tensor, WtA: torch.Tensor,
                           H: torch.Tensor, WtW: torch.Tensor,
                           HHt: torch.Tensor) -> torch.Tensor:
    """||A − WH||² from byproducts.  ``WtA`` and ``H`` are (k, n) — or both
    transposed, (n, k), which the port's engine passes since it keeps Hᵀ —
    and WtW/HHt are the k×k Grams of the *current* W and H."""
    cross = (WtA.float() * H.float()).sum()
    quad = (WtW.float() * HHt.float()).sum()
    return normA_sq - 2.0 * cross + quad


def relative_error(A: torch.Tensor, W: torch.Tensor,
                   H: torch.Tensor) -> torch.Tensor:
    """Direct (serial, small-problem) relative error."""
    normA_sq = sq_frobenius(A)
    WtA = W.T @ A
    sq = sq_error_from_products(normA_sq, WtA, H, W.T @ W, H @ H.T)
    return torch.sqrt(torch.clamp_min(sq, 0.0)) / torch.sqrt(normA_sq)
