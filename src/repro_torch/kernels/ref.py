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

#: the TPU kernels' fixed division guard (``repro/kernels/ref.py:13``); the
#: update rules pass ``rules.eps_for(X.dtype)`` instead
LUC_EPS = 1e-16


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


def mu_update(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor,
              eps: float = LUC_EPS) -> torch.Tensor:
    """X ⊙ (R / (X·G + ε)) (paper eq. (3)) in fp32, returned in X's dtype,
    in the reference's order of operations ``x * (r / (xg + eps))``."""
    X32 = _f32(X)
    denom = X32 @ _f32(G) + eps
    return (X32 * (_f32(R) / denom)).to(X.dtype)


def hals_sweep(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor,
               eps: float = LUC_EPS) -> torch.Tensor:
    """Sequential fast-HALS column sweep, H-step form (no normalisation):

        x_i ← max(0, x_i + (R_i − X·G_i) / max(G_ii, ε))   for i = 0..k-1

    in order, in fp32.  It follows the kernel, not ``repro/kernels/ref.py``
    (which returns fp32): the result has X's dtype, and each new column is
    rounded to X's dtype before later columns read it, as the update rule
    ``rules.update_hals`` does (a no-op in fp32)."""
    G32, R32 = _f32(G), _f32(R)
    out = X.clone(memory_format=torch.contiguous_format)
    X32 = out if out.dtype == torch.float32 else out.float()
    for i in range(G.shape[0]):
        gii = torch.clamp_min(G32[i, i], eps)
        xi = X32[:, i] + (R32[:, i] - X32 @ G32[:, i]) / gii
        out[:, i] = torch.clamp_min(xi, 0.0).to(out.dtype)
        if X32 is not out:
            X32[:, i] = out[:, i].float()
    return out


def hals_sweep_norm(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor,
                    eps: float = LUC_EPS, norm_psum=None) -> torch.Tensor:
    """Sequential HALS column sweep, W-step form (paper eq. (5)), each new
    column normalised:

        x_i ← [x_i·G_ii + R_i − X·G_i]_+ ;  x_i ← x_i / max(‖x_i‖, ε) where
        ‖x_i‖ > 0   for i = 0..k-1

    in order, with no division by G_ii.  Products in G's precision (fp32
    for a bf16 carry, as JAX promotes), the sum of squares in fp32, each
    column rounded to X's dtype before later columns read it.
    ``norm_psum`` sums a column's sum of squares over the ranks that hold
    the other rows (None: all rows are here).  Returns a new contiguous
    tensor in X's dtype; X is not modified."""
    k = G.shape[0]
    X = X.clone(memory_format=torch.contiguous_format)
    Xg = X if X.dtype == G.dtype else X.to(G.dtype)
    for i in range(k):
        gii = G[i, i]
        xi = Xg[:, i] * gii + R[:, i] - Xg @ G[:, i]
        xi = torch.clamp_min(xi, 0.0)
        sq = torch.sum(torch.square(xi.float()))
        if norm_psum is not None:
            sq = norm_psum(sq)
        nrm = torch.sqrt(sq).to(xi.dtype)
        # Guard the all-zero column (paper's code resets to machine eps).
        xi = torch.where(nrm > 0, xi / torch.clamp_min(nrm, eps), xi)
        X[:, i] = xi.to(X.dtype)
        if Xg is not X:
            Xg[:, i] = X[:, i].to(Xg.dtype)
    return X


def hals_sweep_f64(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor,
                   eps: float = LUC_EPS,
                   chunk: int = 1 << 20) -> torch.Tensor:
    """``hals_sweep`` in float64 sums, the exact value a kernel and this
    module's version are both held against where fp32 sums cancel; each
    new column is rounded to X's dtype before later columns read it, as
    both of them do.  Rows go in chunks of ``chunk`` (they are
    independent), so the float64 copies stay small."""
    G64 = G.double()
    out = torch.empty(X.shape, dtype=torch.float64, device=X.device)
    for r0 in range(0, X.shape[0], chunk):
        rows = slice(r0, r0 + chunk)
        X64, R64 = X[rows].double(), R[rows].double()
        for i in range(G.shape[0]):
            xi = (X64[:, i] + (R64[:, i] - X64 @ G64[:, i])
                  / max(G64[i, i].item(), eps)).clamp_min(0.0)
            X64[:, i] = xi.to(X.dtype).double()
        out[rows] = X64
    return out


def sweep_scaled_err(got: torch.Tensor, want: torch.Tensor, X: torch.Tensor,
                     G: torch.Tensor, R: torch.Tensor, eps: float = LUC_EPS,
                     chunk: int = 1 << 20) -> float:
    """The largest over columns i of a HALS sweep of column i's max |got −
    want| over the size of what its update adds and cancels: max over rows
    of |x_i| + (|r_i| + Σ_l |x_l|·|G_li|) / max(G_ii, ε), x the sweep's
    state when column i is updated (columns before i new, from ``want``;
    the others from X).  An fp32 sum's rounding is relative to that size,
    not to the new x_i, which cancellation can leave small.  Rows go in
    chunks of ``chunk`` (the maxima over rows split)."""
    k = G.shape[0]
    Ga = G.double().abs()
    before = torch.ones(k, k, dtype=torch.bool, device=G.device).triu(1)
    Gb, Ga_ = Ga * before, Ga * ~before
    diag = G.double().diagonal().clamp_min(eps)
    diff = torch.zeros(k, dtype=torch.float64, device=G.device)
    scale = torch.zeros(k, dtype=torch.float64, device=G.device)
    for r0 in range(0, X.shape[0], chunk):
        rows = slice(r0, r0 + chunk)
        w, x = want[rows].double(), X[rows].double()
        cancel = w.abs() @ Gb + x.abs() @ Ga_ + R[rows].double().abs()
        cancel = cancel / diag + x.abs()
        scale = torch.maximum(scale, cancel.amax(0))
        diff = torch.maximum(diff, (got[rows].double() - w).abs().amax(0))
        del w, x, cancel
    return (diff / scale.clamp_min(1e-30)).max().item()
