"""Plain PyTorch versions of the port's CUDA kernels — the counterpart of
``repro/kernels/ref.py`` (and, for the SpMMs, of the reference's XLA
scatter-add in ``core/blocksparse.py``).

The kernel wrappers (``kernels/ops.py``) run these on CPU tensors, and
``chip_smoke.py`` holds each kernel against its version here on the card.
Inputs are upcast to fp32 first, so a bf16 input is multiplied exactly and
summed in fp32, like the kernels (and like ``preferred_element_type`` in
the reference).
"""

from __future__ import annotations

import torch

#: elements of one (triplets, k) fp32 temporary of the SpMMs (256 MiB)
_CHUNK_ELEMS = 1 << 26


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def gram(X: torch.Tensor) -> torch.Tensor:
    """XᵀX with fp32 accumulation."""
    X = _f32(X)
    return X.T @ X


def ts_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B, B tall-skinny (n × k), fp32 accumulation."""
    return _f32(A) @ _f32(B)


def ts_matmul_t(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ B through the transposed view: Aᵀ is not materialised."""
    return _f32(A).T @ _f32(B)


def spmm(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
         B: torch.Tensor, m_out: int) -> torch.Tensor:
    """Scatter-add SpMM: out[rows[i]] += vals[i] · B[cols[i]], (m_out, k)
    fp32, with ``index_add_`` over chunks of triplets (the (nnz, k)
    products of the whole matrix would be 29 GB at the sparse path's full
    size).  Aᵀ·B is the same call with rows and cols swapped."""
    k = B.shape[1]
    out = torch.zeros((m_out, k), dtype=torch.float32, device=B.device)
    B32 = _f32(B)
    step = max(1, _CHUNK_ELEMS // max(1, k))
    for s in range(0, vals.numel(), step):
        v = vals[s:s + step].float()
        out.index_add_(0, rows[s:s + step].long(),
                       v[:, None] * B32[cols[s:s + step].long()])
    return out


def spmm_sorted(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                tiles: torch.Tensor, valid: torch.Tensor, B: torch.Tensor,
                m_out: int, *, align: int) -> torch.Tensor:
    """The same product from the ``sort_rows`` packed layout: only the
    first ``valid[u]`` slots of each ``align``-slot unit u are added.  The
    rows are absolute, so the tile ids (``tiles``) add nothing here."""
    del tiles
    k = B.shape[1]
    out = torch.zeros((m_out, k), dtype=torch.float32, device=B.device)
    B32 = _f32(B)
    slot = torch.arange(align, device=valid.device)
    units = max(1, _CHUNK_ELEMS // max(1, k * align))
    for u0 in range(0, valid.numel(), units):
        keep = (slot[None, :] < valid[u0:u0 + units, None]).reshape(-1)
        span = slice(u0 * align, u0 * align + keep.numel())
        v = vals[span][keep].float()
        out.index_add_(0, rows[span][keep].long(),
                       v[:, None] * B32[cols[span][keep].long()])
    return out
