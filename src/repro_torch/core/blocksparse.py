"""Block-local sparse storage and the local SpMM products of the sparse path.
Counterpart of ``repro/core/blocksparse.py``.

A sparse A on a gr × gc grid is stored as per-block COO triplets padded to
the largest block's nonzero count, in three ``(gr, gc, nnz_max)`` tensors:
``vals`` (A's dtype) and int32 ``rows``/``cols`` *within* the block.
Padding triplets are ``(row=0, col=0, val=0)``: no-ops for a scatter-add
SpMM.  The serial path uses a 1 × 1 grid; on a grid each rank holds its
own block as a 1 × 1 BlockCOO (``block``).  ``blockify`` re-blocks a
BlockCOO onto another grid; ``pad_nnz`` pads the triplet dimension to a
multiple of the rank count (the gspmd layout, ``core/gspmd.py``).

``sort_rows`` reorders each block's triplets by row into the reference's
tile-aligned packed layout (array for array the same): a stable sort, each
8-row output tile's segment zero-padded to a multiple of ``align`` with
``(row = tile's first row, col = 0, val = 0)``, and per block

  * ``row_offsets`` (mb+1,)  CSR-style prefix counts over the *unpadded*
    sorted order (the ``_pack_triplets`` padding sorts into row 0);
  * ``row_tiles``   (U,)     the 8-row tile each ``align``-slot unit
    belongs to (non-decreasing);
  * ``row_valid``   (U,)     how many of the unit's slots are real;

and, not in the reference's pytree (``LEAVES``), the layout's fixed
per-tile first units that the kernel reads

  * ``row_first``   (mb/8+1,)  tile t owns units [row_first[t],
                               row_first[t+1]) (``ops.first_units``);

plus a column-sorted transposed copy (``t_vals``/``t_rows``/``t_cols`` with
``col_offsets``/``col_tiles``/``col_valid``, and ``col_first``): there the
original *columns*
drive the sort, so ``t_rows`` holds column indices and ``local_spmm_t``
runs the same kernel on it.  Unlike the reference, which loops over every
tile on the host, the layout is built with vectorised torch operations on
A's device.

Three products back ``repro_torch.backends.SparseOps``:

    impl="scatter"  ``index_add_`` in fp32 (kernels/ref.py, the plain version)
    impl="cuda"     kernels/ops.spmm, the unsorted CUDA kernel (atomics)
    impl="sorted"   kernels/ops.spmm_sorted, the row-sorted CUDA kernel

On CPU tensors the two kernel wrappers run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops, ref

#: Default packed-segment alignment of ``sort_rows`` (slots per unit).
DEFAULT_ALIGN = 64

#: Output-row granularity of the sorted layout (rows per tile).
ROW_TILE = 8

IMPLS = ("scatter", "cuda", "sorted")

# The leaves that hold tensors, in the reference's pytree order.
_SORT_FIELDS = ("row_offsets", "row_tiles", "row_valid",
                "t_vals", "t_rows", "t_cols",
                "col_offsets", "col_tiles", "col_valid")
LEAVES = ("vals", "rows", "cols") + _SORT_FIELDS
# Computed from the layout once, where sort_rows builds it; a layout made
# elsewhere (blockcoo_from_numpy, by hand) lacks them and spmm_sorted then
# computes them per call.
FIRST_FIELDS = ("row_first", "col_first")

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class BlockCOO:
    """A (gr, gc)-blocked sparse matrix as padded block-local COO triplets.

    ``vals``/``rows``/``cols`` are (gr, gc, nnz_max) tensors, ``shape`` the
    global (m, n), ``block_shape`` (m/gr, n/gc) and ``nnz`` the true
    (pre-padding) nonzero count.  After ``sort_rows()`` the triplets are in
    the packed layout (module docstring) and the nine metadata leaves are
    set; ``align`` records the packing alignment (0: unsorted).
    ``row_major`` is true when each block's triplets are known to come in
    row order (built from a dense tensor, CSR or a coalesced COO, or
    row-sorted): the unsorted kernel's A·B then takes its single pass.
    """

    vals: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    shape: tuple[int, int]
    block_shape: tuple[int, int]
    nnz: int
    row_offsets: Any = None
    row_tiles: Any = None
    row_valid: Any = None
    t_vals: Any = None
    t_rows: Any = None
    t_cols: Any = None
    col_offsets: Any = None
    col_tiles: Any = None
    col_valid: Any = None
    align: int = 0
    row_major: bool = False
    row_first: Any = None
    col_first: Any = None

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def grid(self) -> tuple[int, int]:
        return (self.shape[0] // self.block_shape[0],
                self.shape[1] // self.block_shape[1])

    @property
    def has_sorted_rows(self) -> bool:
        return self.row_offsets is not None

    @property
    def has_sorted_cols(self) -> bool:
        return self.col_offsets is not None

    @property
    def is_sorted(self) -> bool:
        """Both orientations sorted: what mm AND mm_t need."""
        return self.has_sorted_rows and self.has_sorted_cols

    def to(self, device) -> "BlockCOO":
        """The same matrix with every leaf on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in LEAVES + FIRST_FIELDS
            if getattr(self, f) is not None})

    def sort_rows(self, *, align: int = DEFAULT_ALIGN,
                  orient: str = "both") -> "BlockCOO":
        """Row-sorted copy with the packed-layout metadata (module-level
        ``sort_rows``); the same matrix."""
        return sort_rows(self, align=align, orient=orient)

    def todense(self) -> torch.Tensor:
        """A dense tensor on the leaves' device (tests and small problems);
        duplicate triplets add up, as in the SpMM."""
        gr, gc = self.grid
        mb, nb = self.block_shape
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        for i in range(gr):
            for j in range(gc):
                out[i * mb:(i + 1) * mb, j * nb:(j + 1) * nb].index_put_(
                    (self.rows[i, j].long(), self.cols[i, j].long()),
                    self.vals[i, j], accumulate=True)
        return out


def _pack_triplets(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                   m: int, n: int, gr: int, gc: int, nnz: int,
                   row_major: bool) -> BlockCOO:
    """Pack global COO triplets (tensors on any device) into the padded
    per-block layout, stable in the given order within each block (so
    ``row_major`` input stays row-major in every block).
    Zero-valued triplets are kept: no-ops under scatter-add."""
    if m % gr or n % gc:
        raise ValueError(f"A of shape {(m, n)} does not tile a "
                         f"{gr}×{gc} grid")
    mb, nb = m // gr, n // gc
    if max(mb, nb) > _INT32_MAX:
        raise ValueError(f"block {mb}×{nb} exceeds int32 indices")
    dev, count = vals.device, vals.numel()
    if gr * gc == 1:              # one block: the order is the input's
        nnz_max = max(count, 1)
        V = torch.zeros((1, nnz_max), dtype=vals.dtype, device=dev)
        R = torch.zeros((1, nnz_max), dtype=torch.int32, device=dev)
        C = torch.zeros((1, nnz_max), dtype=torch.int32, device=dev)
        V[0, :count] = vals
        R[0, :count] = rows.to(torch.int32)
        C[0, :count] = cols.to(torch.int32)
    else:
        rows, cols = rows.long(), cols.long()
        flat = (rows // mb) * gc + cols // nb
        flat_s, order = torch.sort(flat, stable=True)
        counts = torch.bincount(flat_s, minlength=gr * gc)
        nnz_max = max(int(counts.max()), 1)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(count, device=dev) - starts[flat_s]
        V = torch.zeros((gr * gc, nnz_max), dtype=vals.dtype, device=dev)
        R = torch.zeros((gr * gc, nnz_max), dtype=torch.int32, device=dev)
        C = torch.zeros((gr * gc, nnz_max), dtype=torch.int32, device=dev)
        V[flat_s, slot] = vals[order]
        R[flat_s, slot] = (rows[order] % mb).to(torch.int32)
        C[flat_s, slot] = (cols[order] % nb).to(torch.int32)
    return BlockCOO(vals=V.reshape(gr, gc, nnz_max),
                    rows=R.reshape(gr, gc, nnz_max),
                    cols=C.reshape(gr, gc, nnz_max),
                    shape=(m, n), block_shape=(mb, nb), nnz=int(nnz),
                    row_major=row_major)


def from_bcoo(A: torch.Tensor, gr: int, gc: int) -> BlockCOO:
    """Blockify a ``torch.sparse_coo_tensor`` (PyTorch's counterpart of
    BCOO) for a gr×gc grid, keeping its triplets as stored (an uncoalesced
    tensor's duplicates add up in the products).  A coalesced tensor's
    triplets are row-major."""
    idx, vals = A._indices(), A._values()
    return _pack_triplets(vals, idx[0], idx[1], A.shape[0], A.shape[1],
                          gr, gc, nnz=vals.numel(),
                          row_major=A.is_coalesced())


def _global_triplets(blk: BlockCOO):
    """Flat global-index triplets of a BlockCOO, padding stripped, on the
    leaves' device.

    The stored tensors carry zero-valued no-op entries: the per-block
    nnz_max padding and, after ``sort_rows``, the tile-alignment padding
    and ``_stack_padded`` tails.  Re-blocking them as if they were real
    triplets would inflate the new blocking's nnz_max on every grid change,
    so they are dropped: all padding has val == 0 exactly, and zero-valued
    triplets are no-ops under scatter-add (explicit zeros of the data go
    too; ``nnz`` travels separately)."""
    gr, gc = blk.grid
    mb, nb = blk.block_shape
    dev = blk.device
    bi = torch.arange(gr, dtype=torch.int64, device=dev)[:, None, None]
    bj = torch.arange(gc, dtype=torch.int64, device=dev)[None, :, None]
    vals = blk.vals.reshape(-1)
    rows = (blk.rows.long() + bi * mb).reshape(-1)
    cols = (blk.cols.long() + bj * nb).reshape(-1)
    keep = vals != 0
    return vals[keep], rows[keep], cols[keep]


def block(blk: BlockCOO, i: int, j: int) -> BlockCOO:
    """Block (i, j) of a blocked matrix as a 1 × 1 BlockCOO of
    ``block_shape`` (every leaf sliced, sorted layouts included, so the
    block keeps its padding); a 1 × 1 BlockCOO is returned as it is."""
    if blk.grid == (1, 1) and (i, j) == (0, 0):
        return blk
    gr, gc = blk.grid
    if not (0 <= i < gr and 0 <= j < gc):
        raise ValueError(f"block ({i}, {j}) outside a {gr}×{gc} grid")
    leaves = {f: getattr(blk, f)[i:i + 1, j:j + 1]
              for f in LEAVES + FIRST_FIELDS if getattr(blk, f) is not None}
    return dataclasses.replace(
        blk, **leaves, shape=blk.block_shape,
        nnz=int(torch.count_nonzero(leaves["vals"])))


def local_block(A, gr: int, gc: int, i: int, j: int) -> BlockCOO:
    """Block (i, j) of A on a gr × gc grid as a 1 × 1 BlockCOO of the
    block's shape, without laying out the other blocks: the triplets of A
    (a BlockCOO's with its padding stripped; any other input blockified
    1 × 1 first) that fall in the block, in their order, shifted to the
    block's origin.  A BlockCOO already on this grid gives its block as it
    is laid out (``block``), a 1 × 1 one itself."""
    if isinstance(A, BlockCOO) and A.grid == (gr, gc):
        return block(A, i, j)
    m, n = A.shape
    if m % gr or n % gc:
        raise ValueError(f"A of shape {(m, n)} does not tile a "
                         f"{gr}×{gc} grid")
    if not (0 <= i < gr and 0 <= j < gc):
        raise ValueError(f"block ({i}, {j}) outside a {gr}×{gc} grid")
    if not isinstance(A, BlockCOO):
        A = blockify(A, 1, 1)
    mb, nb = m // gr, n // gc
    vals, rows, cols = _global_triplets(A)
    keep = ((rows >= i * mb) & (rows < (i + 1) * mb)
            & (cols >= j * nb) & (cols < (j + 1) * nb))
    vals, rows, cols = vals[keep], rows[keep] - i * mb, cols[keep] - j * nb
    del keep
    return _pack_triplets(vals, rows, cols, mb, nb, 1, 1, nnz=vals.numel(),
                          row_major=A.row_major and A.grid[1] == 1)


def blockify(A, gr: int, gc: int) -> BlockCOO:
    """BlockCOO from a dense tensor, a numpy array (float64 becomes
    float32, as ``jnp.asarray`` makes it in the reference), a sparse COO or
    CSR tensor, or a BlockCOO (re-blocked if its grid differs: its
    triplets, padding stripped, repacked for this grid).  Dense input
    keeps its nonzeros in row-major order, as ``BCOO.fromdense`` does."""
    if isinstance(A, BlockCOO):
        if A.grid == (gr, gc):
            return A
        vals, rows, cols = _global_triplets(A)
        # row-major survives when the old blocks stack rows (one block
        # column): block i's rows all come before block i + 1's
        return _pack_triplets(vals, rows, cols, A.shape[0], A.shape[1],
                              gr, gc, nnz=A.nnz,
                              row_major=A.row_major and A.grid[1] == 1)
    if isinstance(A, np.ndarray):
        if A.dtype == np.float64:
            A = A.astype(np.float32)
        A = torch.from_numpy(np.ascontiguousarray(A))
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"cannot blockify {type(A).__name__}; pass a tensor, "
                        f"a numpy array or a BlockCOO")
    if A.layout == torch.sparse_csr:
        A = A.to_sparse_coo()
    if A.layout == torch.sparse_coo:
        return from_bcoo(A, gr, gc)
    if A.dim() != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
    r, c = torch.nonzero(A, as_tuple=True)
    return _pack_triplets(A[r, c], r, c, A.shape[0], A.shape[1], gr, gc,
                          nnz=r.numel(), row_major=True)


def sq_norm(A: BlockCOO) -> torch.Tensor:
    """||A||_F² as an fp32 scalar: squares in fp32 summed in float64, as
    ``core/error.sq_frobenius`` does (padding values are exact zeros).
    The reference sums in fp32, whose result depends on the triplet order;
    this does not, to fp32 rounding."""
    v = A.vals.float()
    return (v * v).sum(dtype=torch.float64).float()


def pad_nnz(blk: BlockCOO, multiple: int) -> BlockCOO:
    """Pad each block's triplet dim to a multiple (zero no-op entries), so
    the nnz dimension splits evenly over ranks — the gspmd sparse layout.
    Drops any ``sort_rows`` metadata: tail padding breaks the tile-aligned
    packed layout.  ``row_major`` survives only where nothing is padded:
    the padding triplets sit at row 0, after every later row."""
    nnz_max = blk.vals.shape[-1]
    pad = (-nnz_max) % multiple
    if pad == 0 and not blk.align:
        return blk

    def padded(t):
        return torch.nn.functional.pad(t, (0, pad))

    return BlockCOO(vals=padded(blk.vals), rows=padded(blk.rows),
                    cols=padded(blk.cols), shape=blk.shape,
                    block_shape=blk.block_shape, nnz=blk.nnz,
                    row_major=blk.row_major and pad == 0)


# ---------------------------------------------------------------------------
# Row sorting: the packed layout of kernels/ops.spmm_sorted
# ---------------------------------------------------------------------------

def _sorted_layout(vals, rows, cols, dim: int, align: int):
    """Sort ONE block's triplets by ``rows`` and pack them per 8-row tile,
    each tile's segment zero-padded to a multiple of ``align``; vectorised
    on the tensors' device.

    Returns (pv, pr, pc, offsets, tiles, valid): the packed triplets (U ·
    align,), CSR offsets over the unpadded sorted order (dim+1,) int32, and
    per-unit tile ids and valid counts (U,) int32.  Temporaries are freed
    as soon as they are used: at 144.8 M triplets each int64 one is 1.2 GB.
    """
    dev, count = rows.device, rows.numel()
    if count > _INT32_MAX:
        raise ValueError(f"{count} triplets in one block exceed int32 "
                         f"offsets")
    sr, order = torch.sort(rows, stable=True)
    sv, sc = vals[order], cols[order]
    del order
    per_row = torch.bincount(sr, minlength=dim)
    offs = torch.zeros(dim + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_row, 0, out=offs[1:])
    del per_row
    ntiles = -(-dim // ROW_TILE)
    bounds = torch.clamp_max(
        torch.arange(ntiles + 1, device=dev) * ROW_TILE, dim)
    t_start, t_end = offs[bounds[:-1]], offs[bounds[1:]]
    lens = t_end - t_start
    units = (lens + align - 1) // align         # 0: an empty tile, no units
    unit_start = torch.cumsum(units, 0) - units
    n_units = int(units.sum())
    tiles = torch.repeat_interleave(
        torch.arange(ntiles, dtype=torch.int32, device=dev), units,
        output_size=n_units)
    tl = tiles.long()
    nth = torch.arange(n_units, device=dev) - unit_start[tl]
    valid = torch.clamp(lens[tl] - nth * align, 0, align).to(torch.int32)
    del tl, nth
    # every slot starts as padding (tile's first row, col 0, val 0) ...
    pr = torch.repeat_interleave(tiles * ROW_TILE, align)
    pc = torch.zeros(n_units * align, dtype=torch.int32, device=dev)
    pv = torch.zeros(n_units * align, dtype=vals.dtype, device=dev)
    # ... then the sorted triplets go to their tile's segment, in order
    tile_of = (sr // ROW_TILE).long()
    pos = torch.arange(count, device=dev)
    pos += unit_start[tile_of] * align - t_start[tile_of]
    del tile_of
    pv[pos] = sv
    pr[pos] = sr
    pc[pos] = sc
    return pv, pr, pc, offs.to(torch.int32), tiles, valid


def _stack_padded(arrs, gr: int, gc: int, fills=None) -> torch.Tensor:
    """Stack per-block 1-D tensors into (gr, gc, X), padding each to the
    longest with 0, or with ``fills[b]`` (the tile id tail padding carries:
    the block's last real tile, so the padding stays on one output tile)."""
    if len(arrs) == 1:
        return arrs[0].reshape(gr, gc, -1)
    longest = max(a.numel() for a in arrs)
    out = arrs[0].new_zeros((len(arrs), longest))
    for b, a in enumerate(arrs):
        out[b, :a.numel()] = a
        if fills is not None:
            out[b, a.numel():] = fills[b]
    return out.reshape(gr, gc, longest)


def _sorted_leaves(V, R, C, dim: int, align: int, gr: int, gc: int):
    """(vals, rows, cols, offsets, tiles, valid, first), each (gr, gc, ·),
    of every block sorted by ``R``; ``first`` the per-tile first units of
    the stacked (tail-padded) tiles."""
    lay = [_sorted_layout(V[b], R[b], C[b], dim, align)
           for b in range(gr * gc)]
    last_tile = [int(x[4][-1]) if x[4].numel() else 0 for x in lay]
    tiles = _stack_padded([x[4] for x in lay], gr, gc, last_tile)
    first = ops.first_units(tiles.reshape(gr * gc, -1), -(-dim // ROW_TILE))
    return (_stack_padded([x[0] for x in lay], gr, gc),
            _stack_padded([x[1] for x in lay], gr, gc),
            _stack_padded([x[2] for x in lay], gr, gc),
            torch.stack([x[3] for x in lay]).reshape(gr, gc, -1),
            tiles,
            _stack_padded([x[5] for x in lay], gr, gc),
            first.reshape(gr, gc, -1))


def sort_rows(blk: BlockCOO, *, align: int = DEFAULT_ALIGN,
              orient: str = "both") -> BlockCOO:
    """Row-sorted copy of ``blk`` in the packed layout that
    ``kernels/ops.spmm_sorted`` streams (module docstring), built on the
    leaves' device.  The same matrix: a stable sort, and padding that adds
    nothing.

    ``orient="rows"`` (mm only) skips the transposed copy; ``"cols"``
    (mm_t only) keeps the triplets as they are and adds only the
    transposed copy.  Default ``"both"``.
    """
    if align <= 0 or align % ROW_TILE:
        raise ValueError(f"align must be a positive multiple of {ROW_TILE}, "
                         f"got {align}")
    if orient not in ("both", "rows", "cols"):
        raise ValueError(f"orient must be both|rows|cols, got {orient!r}")
    gr, gc = blk.grid
    mb, nb = blk.block_shape
    V = blk.vals.reshape(gr * gc, -1)
    R = blk.rows.reshape(gr * gc, -1)
    C = blk.cols.reshape(gr * gc, -1)
    kw: dict = {}
    if orient != "cols":
        names = ("vals", "rows", "cols", "row_offsets", "row_tiles",
                 "row_valid", "row_first")
        kw.update(zip(names, _sorted_leaves(V, R, C, mb, align, gr, gc)))
    if orient != "rows":               # Aᵀ: the columns drive the sort
        names = ("t_vals", "t_rows", "t_cols", "col_offsets", "col_tiles",
                 "col_valid", "col_first")
        kw.update(zip(names, _sorted_leaves(V, C, R, nb, align, gr, gc)))
    return dataclasses.replace(blk, align=align,
                               row_major=blk.row_major or orient != "cols",
                               **kw)


# ---------------------------------------------------------------------------
# Local SpMM: what SparseOps.mm / mm_t run
# ---------------------------------------------------------------------------

def _require_sorted(blk: BlockCOO, orientation: bool, leaf) -> None:
    if not orientation:
        raise ValueError(
            "impl='sorted' needs the sorted layout for this orientation — "
            "call BlockCOO.sort_rows() first (SparseOps(spmm_impl='sorted') "
            "does this in prepare; orient='rows' covers mm only, 'cols' "
            "mm_t only)")
    if tuple(leaf.shape[:2]) != (1, 1):
        raise ValueError(
            f"local_spmm(impl='sorted') operates on ONE local block; got "
            f"leaves blocked {leaf.shape[0]}×{leaf.shape[1]}")


def _flat(t):
    return None if t is None else t.reshape(-1)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def local_spmm(blk: BlockCOO, B: torch.Tensor, *,
               impl: str = "scatter") -> torch.Tensor:
    """A_blk @ B: (m_blk, n_blk) sparse × (n_blk, k) → (m_blk, k) fp32."""
    _check_impl(impl)
    m_out = blk.block_shape[0]
    if impl == "sorted":
        _require_sorted(blk, blk.has_sorted_rows, blk.vals)
        return ops.spmm_sorted(
            blk.vals.reshape(-1), blk.rows.reshape(-1), blk.cols.reshape(-1),
            blk.row_tiles.reshape(-1), blk.row_valid.reshape(-1), B, m_out,
            align=blk.align, first=_flat(blk.row_first))
    v, r, c = blk.vals.reshape(-1), blk.rows.reshape(-1), blk.cols.reshape(-1)
    if impl == "cuda":
        return ops.spmm(v, r, c, B, m_out, row_major=blk.row_major)
    return ref.spmm(v, r, c, B, m_out)


def local_spmm_t(blk: BlockCOO, B: torch.Tensor, *,
                 impl: str = "scatter") -> torch.Tensor:
    """A_blkᵀ @ B without transposing storage: the same products with rows
    and cols swapped, or for impl="sorted" the same kernel over the
    column-sorted transposed copy."""
    _check_impl(impl)
    n_out = blk.block_shape[1]
    if impl == "sorted":
        _require_sorted(blk, blk.has_sorted_cols, blk.t_vals)
        return ops.spmm_sorted(
            blk.t_vals.reshape(-1), blk.t_rows.reshape(-1),
            blk.t_cols.reshape(-1), blk.col_tiles.reshape(-1),
            blk.col_valid.reshape(-1), B, n_out, align=blk.align,
            first=_flat(blk.col_first))
    v, r, c = blk.vals.reshape(-1), blk.rows.reshape(-1), blk.cols.reshape(-1)
    if impl == "cuda":
        return ops.spmm_t(v, r, c, B, n_out)
    return ref.spmm(v, c, r, B, n_out)
