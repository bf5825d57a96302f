"""Wrappers around the port's CUDA kernels — the counterpart of
``repro/kernels/ops.py`` (``gram`` :109, ``ts_matmul`` :153,
``ts_matmul_t`` :174, ``spmm`` :195, ``spmm_t`` :230, ``spmm_sorted`` :254).

Each wrapper

  * checks device, dtype (fp32 or bf16, the same for every float operand;
    int32 indices), shape and contiguity, and raises on anything its kernel
    does not take;
  * on a CPU tensor, runs the plain PyTorch version (``kernels/ref.py``);
  * on a CUDA tensor, allocates the output (and the slab scratch) with
    ``torch.empty``, launches the kernel on the current stream, raises if
    the launch returned a CUDA error, and adds one to ``LAUNCHES[name]``.
    There is no fallback: a CUDA tensor gets the kernel or an exception.

Unlike the reference, nothing is padded: the kernels mask ragged edges
themselves, so A (56 GB at the paper's Video shape) is never copied.  The
SpMM kernels skip triplets whose indices fall outside the output or B,
as the reference's scatter drops out-of-range updates; the plain versions
raise on them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

#: launches of each kernel on CUDA tensors since the last reset
LAUNCHES = {"gram": 0, "ts_matmul": 0, "ts_matmul_t": 0, "spmm": 0,
            "spmm_sorted": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLABS = 65535                         # gridDim.z limit
_TILE_COUNTS = {"ts_matmul": 3, "gram": 2}
_TILES: dict[str, tuple[int, ...]] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, *tensors: torch.Tensor) -> bool:
    """Validate operands; True when they lie on a CUDA device."""
    if not all(isinstance(t, torch.Tensor) and t.layout == torch.strided
               for t in tensors):
        raise TypeError(f"{name}: operands must be dense tensors")
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.dim() != 2 or 0 in t.shape:
            raise ValueError(f"{name}: operands must be non-empty 2-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: operands must share device and dtype, "
                             f"got {dev}/{dt} and {t.device}/{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (pass Hᵀ "
                             f"as a contiguous (n, k) tensor, not H.T)")
    if dt not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on cpu or cuda, got {dev}")
    return dev.type == "cuda"


def plan_slabs(depth: int, tiles: int, sm_count: int, *, step: int,
               min_slab: int, blocks_per_sm: int) -> tuple[int, int]:
    """(slab, slabs) for splitting a contraction of ``depth`` rows over the
    grid's z axis: enough slabs for about ``blocks_per_sm`` blocks per SM
    (``tiles × slabs`` in all), none shorter than ``min_slab`` rows, slab a
    multiple of ``step``; ``slabs × slab`` covers ``depth`` with the last
    slab ragged."""
    want = -(-blocks_per_sm * sm_count // tiles)
    slabs = max(1, min(want, -(-depth // min_slab), _MAX_SLABS))
    slab = -(-depth // slabs)
    slab = -(-slab // step) * step
    return slab, -(-depth // slab)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tiles(name: str) -> tuple[int, ...]:
    """The tile sizes library ``name`` was compiled with, as its
    ``<name>_tiles`` entry point reports them: ts_matmul (BM, BN, BK), gram
    (T, K)."""
    if name not in _TILES:
        out = (ctypes.c_int * _TILE_COUNTS[name])()
        getattr(build.load(name), f"{name}_tiles")(out)
        _TILES[name] = tuple(out)
    return _TILES[name]


def _launch(lib, fn: str, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"{rc} ({msg})")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def gram(X: torch.Tensor) -> torch.Tensor:
    """XᵀX (fp32, (k, k)) for X (r, k)."""
    if not _check("gram", X):
        return ref.gram(X)
    r, k = X.shape
    edge, depth = tiles("gram")
    # one wave of blocks: each output sums every slab, so slabs stay few
    slab, slabs = plan_slabs(r, (-(-k // edge)) ** 2, _sm_count(X.device),
                             step=depth, min_slab=4 * depth, blocks_per_sm=8)
    G = torch.empty((k, k), dtype=torch.float32, device=X.device)
    scratch = (torch.empty((slabs, k, k), dtype=torch.float32,
                           device=X.device) if slabs > 1 else None)
    _launch(build.load("gram"), "gram_launch", "gram", X.device,
            _DTYPE_CODES[X.dtype], X.data_ptr(), G.data_ptr(), _ptr(scratch),
            r, k, slab, slabs)
    return G


def ts_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B (fp32, (m, k)) for A (m, n), B (n, k)."""
    on_cuda = _check("ts_matmul", A, B)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"ts_matmul: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} do not chain")
    if not on_cuda:
        return ref.ts_matmul(A, B)
    m, n = A.shape
    k = B.shape[1]
    C = torch.empty((m, k), dtype=torch.float32, device=A.device)
    _launch(build.load("ts_matmul"), "ts_matmul_launch", "ts_matmul",
            A.device, _DTYPE_CODES[A.dtype], A.data_ptr(), B.data_ptr(),
            C.data_ptr(), m, n, k)
    return C


def ts_matmul_t(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ B (fp32, (n, k)) for A (m, n), B (m, k), without transposing A."""
    on_cuda = _check("ts_matmul_t", A, B)
    if A.shape[0] != B.shape[0]:
        raise ValueError(f"ts_matmul_t: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} do not share rows")
    if not on_cuda:
        return ref.ts_matmul_t(A, B)
    m, n = A.shape
    k = B.shape[1]
    bm, bn, bk = tiles("ts_matmul")
    # ~16 waves at 2 resident blocks per SM, so the last, partial wave
    # costs little; the (slabs, n, k) partials stay small beside A
    slab, slabs = plan_slabs(m, -(-n // bm) * -(-k // bn), _sm_count(A.device),
                             step=bk, min_slab=4 * bk, blocks_per_sm=32)
    Y = torch.empty((n, k), dtype=torch.float32, device=A.device)
    scratch = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    _launch(build.load("ts_matmul"), "ts_matmul_t_launch", "ts_matmul_t",
            A.device, _DTYPE_CODES[A.dtype], A.data_ptr(), B.data_ptr(),
            Y.data_ptr(), _ptr(scratch), m, n, k, slab, slabs)
    return Y


def _check_sparse(name: str, vals: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, B: torch.Tensor, out_rows: int,
                  *int32s: torch.Tensor) -> bool:
    """Validate SpMM operands: 1-D contiguous ``vals`` in B's dtype, int32
    ``rows``/``cols`` of its length (and any further int32 metadata), B a
    non-empty contiguous 2-D tensor, all on one device.  True on CUDA."""
    on_cuda = _check(name, B)
    for t in (vals, rows, cols, *int32s):
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            raise TypeError(f"{name}: operands must be dense tensors")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: triplets and metadata must be "
                             f"contiguous 1-D tensors, got shape "
                             f"{tuple(t.shape)}")
        if t.device != B.device:
            raise ValueError(f"{name}: operands must share a device, got "
                             f"{t.device} and {B.device}")
    if vals.dtype != B.dtype:
        raise ValueError(f"{name}: vals and B must share a dtype, got "
                         f"{vals.dtype} and {B.dtype}")
    if any(t.dtype != torch.int32 for t in (rows, cols, *int32s)):
        raise TypeError(f"{name}: indices must be int32")
    if not rows.numel() == cols.numel() == vals.numel():
        raise ValueError(f"{name}: vals/rows/cols lengths differ: "
                         f"{vals.numel()}, {rows.numel()}, {cols.numel()}")
    if out_rows < 1:
        raise ValueError(f"{name}: the output needs at least one row, got "
                         f"{out_rows}")
    return on_cuda


def spmm(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
         B: torch.Tensor, m_out: int) -> torch.Tensor:
    """A @ B (fp32, (m_out, k)) from COO triplets (duplicates add up) and
    B (n, k): the unsorted kernel.  Its fp32 atomics add in an order that
    changes from run to run, so results agree to rounding, not bitwise."""
    if not _check_sparse("spmm", vals, rows, cols, B, m_out):
        return ref.spmm(vals, rows, cols, B, m_out)
    n, k = B.shape
    out = torch.empty((m_out, k), dtype=torch.float32, device=B.device)
    _launch(build.load("spmm"), "spmm_launch", "spmm", B.device,
            _DTYPE_CODES[B.dtype], vals.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), B.data_ptr(), out.data_ptr(), vals.numel(),
            m_out, n, k)
    return out


def spmm_t(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           B: torch.Tensor, n_out: int) -> torch.Tensor:
    """Aᵀ @ B (fp32, (n_out, k)): the same kernel with rows and cols
    swapped, so Aᵀ is never formed."""
    return spmm(vals, cols, rows, B, n_out)


def spmm_sorted(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                tiles: torch.Tensor, valid: torch.Tensor, B: torch.Tensor,
                m_out: int, *, align: int) -> torch.Tensor:
    """A @ B (fp32, (m_out, k)) from the ``sort_rows`` packed layout:
    ``vals``/``rows``/``cols`` of U·align slots, and per unit its 8-row
    tile id (non-decreasing, < ceil(m_out/8)) and valid count.  Each 8-row
    output tile is summed in packed order by one warp and written once;
    rows that own no triplets come out 0.  No atomics: repeated runs are
    bit-identical."""
    on_cuda = _check_sparse("spmm_sorted", vals, rows, cols, B, m_out,
                            tiles, valid)
    if align <= 0 or vals.numel() != tiles.numel() * align:
        raise ValueError(f"spmm_sorted: {vals.numel()} packed slots are not "
                         f"{tiles.numel()} units of align={align}")
    if valid.numel() != tiles.numel():
        raise ValueError(f"spmm_sorted: {valid.numel()} valid counts for "
                         f"{tiles.numel()} units")
    if not on_cuda:
        return ref.spmm_sorted(vals, rows, cols, tiles, valid, B, m_out,
                               align=align)
    n, k = B.shape
    ntiles = -(-m_out // 8)
    # each tile's first unit; tile t owns units [first[t], first[t + 1])
    first = torch.searchsorted(
        tiles, torch.arange(ntiles + 1, dtype=torch.int32, device=B.device),
        out_int32=True)
    out = torch.empty((m_out, k), dtype=torch.float32, device=B.device)
    _launch(build.load("spmm"), "spmm_sorted_launch", "spmm_sorted",
            B.device, _DTYPE_CODES[B.dtype], vals.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), first.data_ptr(),
            valid.data_ptr(), B.data_ptr(), out.data_ptr(), ntiles, m_out, n,
            k, align)
    return out
