"""Sparse backend: block-local COO SpMM — the counterpart of
``repro/backends/sparse.py``.

``prepare`` turns A (a ``BlockCOO``, a sparse COO/CSR tensor, or a dense
tensor or numpy array) into one 1 × 1 ``core.blocksparse.BlockCOO`` on the
solver's device; ``blockify`` gives a grid rank its own block, as a 1 × 1
``BlockCOO`` of the block's shape.  A's nonzeros never cross the wire.
The SpMM lowering is chosen by ``spmm_impl``:

    "scatter"  ``index_add_`` in fp32 (kernels/ref.py) — the plain version
    "cuda"     kernels/ops.spmm — the unsorted CUDA kernel (the counterpart
               of the reference's "pallas"); on CPU tensors its wrapper
               runs the plain version
    "sorted"   kernels/ops.spmm_sorted — the row-sorted CUDA kernel;
               ``prepare`` sorts A (``BlockCOO.sort_rows``, on the device)
               unless it already carries the layout at this ``align``
    "auto"     (default) on CUDA tensors (and fake ones on ``meta``, which
               stand for the card) "sorted" when the BlockCOO carries
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
    supports_panel_dtype = False     # the SpMMs take fp32 factor panels

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
        if A.device.type == "cpu":
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

    def blockify(self, A, gr: int, gc: int, block: tuple[int, int],
                 device: torch.device,
                 products: tuple[str, ...] = ("mm", "mm_t")
                 ) -> blocksparse.BlockCOO:
        """Block (i, j) of A on a gr × gc grid as a 1 × 1 BlockCOO of the
        block's shape on ``device``, cut from A's triplets where A lies
        (``blocksparse.local_block``: no other block is laid out); with
        spmm_impl="sorted", sorted on ``device`` in the orientations
        ``products`` need (mm: rows, mm_t: columns).  The hint must come
        from the schedule: a 1-D faun grid runs both products on one
        block."""
        prods = set(products)
        if not prods or not prods <= {"mm", "mm_t"}:
            raise ValueError(f"products must be a non-empty subset of "
                             f"('mm', 'mm_t'), got {products!r}")
        orient = ("both" if len(prods) == 2
                  else "rows" if prods == {"mm"} else "cols")
        blk = blocksparse.local_block(A, gr, gc, *block)
        return self._sort(blk.to(device), orient=orient)

    def pre_blockify(self, A):
        """Dense input becomes triplets once (a 1 × 1 BlockCOO); each
        ``blockify`` then only repacks them."""
        if isinstance(A, blocksparse.BlockCOO) or (
                isinstance(A, torch.Tensor) and A.layout != torch.strided):
            return A
        return blocksparse.blockify(A, 1, 1)

    def abstract_A(self, m: int, n: int, dtype, nnz: int | None, gr: int,
                   gc: int, device) -> blocksparse.BlockCOO:
        """A stand-in for ``blockify``'s output on a gr × gc grid (a 1 × 1
        BlockCOO of the block's shape holding nnz/(gr·gc) triplets, 1 % of
        the matrix when ``nnz`` is None, as the reference takes it), with
        no data (under a ``FakeTensorMode``: ``lower_step``).  With
        spmm_impl="sorted" it carries the sorted layout in both
        orientations, its packed length U·align standing in for the
        data-dependent one (the reference's stand-in)."""
        nnz = int(nnz) if nnz else max(m * n // 100, 1)
        return _abstract_blockcoo((m // gr, n // gc), -(-nnz // (gr * gc)),
                                  nnz, dtype, device,
                                  self.align if self.spmm_impl == "sorted"
                                  else 0)

    def abstract_global_A(self, m: int, n: int, dtype, nnz: int | None,
                          p: int, device) -> blocksparse.BlockCOO:
        """A stand-in for one rank's share of the gspmd layout: the global
        shape, nnz/p of the padded triplets, unsorted."""
        nnz = int(nnz) if nnz else max(m * n // 100, 1)
        return _abstract_blockcoo((m, n), -(-nnz // p), nnz, dtype, device,
                                  0)

    def norm_sq(self, A) -> torch.Tensor:
        return blocksparse.sq_norm(_require_blockcoo(A, "norm_sq"))

    def global_view_ops(self) -> "SparseOps":
        """The global-view (gspmd) layout splits the flat triplet dim over
        every rank (``pad_global``), which breaks the sorted packed layout,
        so gspmd runs the unsorted products: "auto" on an unsorted A, the
        spmm kernel on CUDA tensors and ``index_add_`` on the CPU (the
        reference forces its XLA scatter for the same reason)."""
        if self.spmm_impl != "sorted":
            return self
        return SparseOps(spmm_impl="auto", align=self.align)

    def pad_global(self, A: blocksparse.BlockCOO, p: int
                   ) -> blocksparse.BlockCOO:
        return blocksparse.pad_nnz(A, p)

    # -- cost model ---------------------------------------------------------

    def mm_flops(self, m: float, n: float, k: float,
                 nnz: float = 0.0) -> float:
        """2·nnz·k per product, two products per iteration."""
        return 4.0 * nnz * k

    def storage_words(self, m: float, n: float, nnz: float = 0.0) -> float:
        """COO triplets: value + row + col per nonzero.  The sorted layout
        stores the triplets twice (row- and column-sorted copies) plus the
        per-row / per-column segment offsets."""
        coo = 3.0 * nnz
        if self.spmm_impl == "sorted":
            return 2.0 * coo + (m + 1) + (n + 1)
        return coo

    def mm_traffic_words(self, m: float, n: float, k: float,
                         nnz: float = 0.0) -> float:
        """Memory words moved by the two A-products per iteration.  The
        unsorted scatter re-reads and re-writes an output row per nonzero
        (2k words); the sorted path streams each output tile once."""
        triplets = 3.0 * nnz
        if self.spmm_impl == "sorted":
            return 2.0 * triplets + 2.0 * nnz * k + (m + n) * k
        return 2.0 * triplets + 2.0 * nnz * k + 4.0 * nnz * k


def _require_blockcoo(A, what: str) -> blocksparse.BlockCOO:
    if not isinstance(A, blocksparse.BlockCOO):
        raise ValueError(f"sparse {what} needs a BlockCOO (prepare() "
                         f"blockifies A), got {type(A).__name__}")
    return A


def _abstract_blockcoo(shape, nnz_blk: int, nnz: int, dtype, device,
                       align: int) -> blocksparse.BlockCOO:
    mb, nb = shape
    nnz_blk = max(nnz_blk, 1)

    def e(size, dt=torch.int32):
        return torch.empty((1, 1, size), dtype=dt, device=device)

    extra = {}
    if align:
        U = -(-nnz_blk // align)
        nnz_blk = U * align
        extra = dict(row_offsets=e(mb + 1), row_tiles=e(U), row_valid=e(U),
                     t_vals=e(nnz_blk, dtype), t_rows=e(nnz_blk),
                     t_cols=e(nnz_blk), col_offsets=e(nb + 1),
                     col_tiles=e(U), col_valid=e(U), align=align,
                     row_first=e(-(-mb // blocksparse.ROW_TILE) + 1),
                     col_first=e(-(-nb // blocksparse.ROW_TILE) + 1))
    return blocksparse.BlockCOO(vals=e(nnz_blk, dtype), rows=e(nnz_blk),
                                cols=e(nnz_blk), shape=(mb, nb),
                                block_shape=(mb, nb), nnz=nnz, **extra)
