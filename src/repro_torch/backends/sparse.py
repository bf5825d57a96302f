"""Sparse backend: block-local COO SpMM — the counterpart of
``repro/backends/sparse.py``, serial (1 × 1 grid) only.

``prepare`` turns A (a ``BlockCOO``, a sparse COO/CSR tensor, or a dense
tensor or numpy array) into one 1 × 1 ``core.blocksparse.BlockCOO`` on the
solver's device.  The SpMM lowering is chosen by ``spmm_impl``:

    "scatter"  ``index_add_`` in fp32 (kernels/ref.py) — the plain version
    "cuda"     kernels/ops.spmm — the unsorted CUDA kernel (the counterpart
               of the reference's "pallas"); on CPU tensors its wrapper
               runs the plain version
    "sorted"   kernels/ops.spmm_sorted — the row-sorted CUDA kernel;
               ``prepare`` sorts A (``BlockCOO.sort_rows``, on the device)
               unless it already carries the layout at this ``align``
    "auto"     (default) on CUDA tensors "sorted" when the BlockCOO carries
               the orientation the product needs, else "cuda"; on CPU
               tensors "scatter".  "auto" never sorts on its own.

Factor panels stay dense, so ``gram`` is the inherited fp32 ``XᵀX``.
"""

from __future__ import annotations

import torch

from repro_torch.backends.base import LocalOps
from repro_torch.core import blocksparse

_IMPLS = ("auto", "scatter", "cuda", "sorted")


class SparseOps(LocalOps):
    name = "sparse"

    def __init__(self, spmm_impl: str = "auto",
                 align: int = blocksparse.DEFAULT_ALIGN):
        if spmm_impl not in _IMPLS:
            raise ValueError(f"spmm_impl must be one of {_IMPLS}, "
                             f"got {spmm_impl!r}")
        self.spmm_impl = spmm_impl
        self.align = align

    def _impl(self, A: blocksparse.BlockCOO, need: str) -> str:
        """Effective impl for one product; ``need`` names the sorted
        orientation it consumes ("rows" for mm, "cols" for mm_t)."""
        if self.spmm_impl != "auto":
            return self.spmm_impl
        if A.device.type != "cuda":
            return "scatter"
        sorted_ok = A.has_sorted_rows if need == "rows" else A.has_sorted_cols
        return "sorted" if sorted_ok else "cuda"

    def _sort(self, blk: blocksparse.BlockCOO,
              orient: str = "both") -> blocksparse.BlockCOO:
        if self.spmm_impl != "sorted":
            return blk
        if (blk.align == self.align
                and (blk.has_sorted_rows or orient == "cols")
                and (blk.has_sorted_cols or orient == "rows")):
            return blk
        return blk.sort_rows(align=self.align, orient=orient)

    # -- products -----------------------------------------------------------

    def mm(self, A, B):
        return blocksparse.local_spmm(_require_blockcoo(A, "mm"), B,
                                      impl=self._impl(A, "rows"))

    def mm_t(self, A, B):
        return blocksparse.local_spmm_t(_require_blockcoo(A, "mm_t"), B,
                                        impl=self._impl(A, "cols"))

    # -- representation -----------------------------------------------------

    def prepare(self, A, device: torch.device) -> blocksparse.BlockCOO:
        """The whole matrix as one 1 × 1 block on ``device``; with
        spmm_impl="sorted", sorted there."""
        return self._sort(blocksparse.blockify(A, 1, 1).to(device))

    def norm_sq(self, A) -> torch.Tensor:
        return blocksparse.sq_norm(_require_blockcoo(A, "norm_sq"))


def _require_blockcoo(A, what: str) -> blocksparse.BlockCOO:
    if not isinstance(A, blocksparse.BlockCOO):
        raise ValueError(f"sparse {what} needs a BlockCOO (prepare() "
                         f"blockifies A), got {type(A).__name__}")
    return A
