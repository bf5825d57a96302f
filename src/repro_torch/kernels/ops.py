"""Wrappers around the port's CUDA kernels — the counterpart of
``repro/kernels/ops.py`` (``gram`` :109, ``ts_matmul`` :153,
``ts_matmul_t`` :174, ``spmm`` :195, ``spmm_t`` :230, ``spmm_sorted`` :254,
``mu_update`` :306, ``hals_sweep`` :319).

Each wrapper

  * checks device, dtype (fp32 or bf16, the same for every float operand of
    the products; int32 indices; for the LUC kernels X fp32 or bf16, G fp32
    and R fp32 or X's dtype, as the update rules hand them over), shape and
    contiguity, and raises on anything its kernel does not take;
  * on a CPU tensor, runs the plain PyTorch version (``kernels/ref.py``);
  * on a CUDA tensor, allocates the output (and the slab or bucket scratch)
    with ``torch.empty``, launches the kernel on the current stream, raises if
    the launch returned a CUDA error, and adds one to ``LAUNCHES[name]``.
    There is no fallback: a CUDA tensor gets the kernel or an exception.

Unlike the reference, nothing is padded: the kernels mask ragged edges
themselves, so A (56 GB at the paper's Video shape) is never copied.  The
SpMM kernels skip triplets whose indices fall outside the output or B,
as the reference's scatter drops out-of-range updates; the plain versions
raise on them.  The LUC kernels take ε as an argument (default the TPU
kernels' 1e-16; the rules pass ``eps_for(X.dtype)``) and k up to
``luc_max_k()`` (128), neither padded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

#: launches of each kernel on CUDA tensors since the last reset
LAUNCHES = {"gram": 0, "ts_matmul": 0, "ts_matmul_t": 0, "spmm": 0,
            "spmm_sorted": 0, "mu_update": 0, "hals_sweep": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLABS = 65535                         # gridDim.z limit

#: the kernels' fixed sizes, as their ``<name>_tiles`` entry points report
#: them (checked on first use): gram (ring stages, super-tile edge, threads
#: per block); ts_matmul and ts_matmul_t (BM output rows, BN columns of k,
#: BK contraction depth per stage, ring stages)
GRAM_TILES = (4, 64, 128)
TS_TILES = (128, 64, 32, 4)
#: shared memory one block may use on the H100 (227 KB)
SMEM_PER_BLOCK = 232_448
#: gram: bytes of X per ring buffer, and the fewest rows a slab takes
GRAM_PANEL_BYTES = 16_384
GRAM_MIN_SLAB = 512
#: blocks per SM that the persistent gram grid and ts_matmul's split
#: contraction aim at: gram three resident blocks; ts_matmul two waves of two
GRAM_BLOCKS_PER_SM = 3
TS_SPLIT_BLOCKS_PER_SM = 4
#: blocks of the tensor-core products resident on one SM (a ring of four
#: ≈ 27 KB stages each: two share an SM's shared memory)
TS_RESIDENT_PER_SM = 2

#: spmm: the bytes of output one bucket of the L2-blocked scatter may cover
#: (of the H100's 50 MB L2), the most buckets its shared-memory cursors
#: hold (spmm.cu's MAX_BUCKETS), triplets per warp of its scatter pass (short,
#: so the blocks in flight stay within a bucket or two), its counting and
#: copying passes' blocks per SM, and the warps per SM a single pass is
#: spread over
SPMM_L2_SHARE = 16 << 20
SPMM_MAX_BUCKETS = 512
SPMM_BUCKET_RUN = 32
SPMM_BUCKET_BLOCKS_PER_SM = 2
SPMM_WARPS_PER_SM = 64

_TILES_EXPECTED = {"gram": GRAM_TILES, "ts_matmul": TS_TILES}
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


class GramPlan(NamedTuple):
    """How the gram kernel cuts X (r, k): ``slabs`` blocks of ``slab`` rows
    (a multiple of ``panel``) per block column, ring buffers of ``panel``
    rows, ``pairs`` block columns (pairs a ≥ b of 64-column super tiles;
    1 for k ≤ 64)."""
    panel: int
    slab: int
    slabs: int
    pairs: int


def plan_gram(r: int, k: int, itemsize: int, sm_count: int) -> GramPlan:
    """The persistent grid of gram: about GRAM_BLOCKS_PER_SM blocks per SM
    in all, each a contiguous slab of at least GRAM_MIN_SLAB rows, streamed
    in panels of about GRAM_PANEL_BYTES, at most 128 rows: a multiple of 32
    (one 8-row step for each of the block's 4 warps), or of 8 for wide k.
    Raises for a k whose ring of 8-row panels exceeds shared memory."""
    stages, sup, threads = GRAM_TILES
    step = 8 * threads // 32
    panel = max(8, min(128, GRAM_PANEL_BYTES // (k * itemsize)))
    panel -= panel % (step if panel >= step else 8)
    # a ring buffer: the panel, a super tile's overrun, a copy's lead-in
    stage = -(-((panel * k + sup) * itemsize + 16) // 16) * 16
    if stages * stage > SMEM_PER_BLOCK:
        raise ValueError(f"gram: k = {k} is too wide for the kernel (a ring "
                         f"of {stages} panels of {panel} rows of {k} needs "
                         f"more than {SMEM_PER_BLOCK} bytes of shared "
                         f"memory)")
    tiles = -(-k // sup)
    pairs = tiles * (tiles + 1) // 2
    slab, slabs = plan_slabs(r, pairs, sm_count, step=panel,
                             min_slab=max(panel, GRAM_MIN_SLAB),
                             blocks_per_sm=GRAM_BLOCKS_PER_SM)
    return GramPlan(panel, slab, slabs, pairs)


def plan_ts_matmul(m: int, n: int, k: int, sm_count: int) -> tuple[int, int]:
    """(slab, slabs) of ts_matmul's contraction over n: one slab when the
    output's BM-row × BN-column tiles fill TS_SPLIT_BLOCKS_PER_SM blocks per
    SM (two waves of two resident blocks); else n is split into slabs of a
    BK multiple (at least 4·BK) until they do."""
    bm, bn, bk, _ = TS_TILES
    tiles = -(-m // bm) * -(-k // bn)
    if tiles >= TS_SPLIT_BLOCKS_PER_SM * sm_count:
        return n, 1
    return plan_slabs(n, tiles, sm_count, step=bk, min_slab=4 * bk,
                      blocks_per_sm=TS_SPLIT_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=256)
def plan_ts_matmul_t(m: int, n: int, k: int,
                     sm_count: int) -> tuple[int, int]:
    """(slab, slabs) of ts_matmul_t's contraction over m: one slab when the
    output's BM-row × BN-column tiles (rows of Y: A's columns) fill
    TS_SPLIT_BLOCKS_PER_SM blocks per SM; else m is split into slabs of a BK
    multiple (at least 4·BK, at most _MAX_SLABS of them) for at least that
    many blocks.  Among 1–4 times that many slabs it takes the count whose
    last wave of TS_RESIDENT_PER_SM blocks per SM wastes least: the fewest
    waves × rows per slab (Video's 108 tiles: 17 slabs, 7 waves, where 5
    would leave a third wave of 12 blocks)."""
    bm, bn, bk, _ = TS_TILES
    tiles = -(-n // bm) * -(-k // bn)
    want = -(-TS_SPLIT_BLOCKS_PER_SM * sm_count // tiles)
    most = max(1, min(-(-m // (4 * bk)), _MAX_SLABS))
    if want <= 1 or most == 1:
        return m, 1
    slots = TS_RESIDENT_PER_SM * sm_count
    best = None
    for s in range(min(want, most), min(4 * want, most) + 1):
        slab = max(4 * bk, -(-(-(-m // s)) // bk) * bk)
        slabs = -(-m // slab)
        cost = -(-tiles * slabs // slots) * slab
        if best is None or cost < best[0]:
            best = (cost, slab, slabs)
    _, slab, slabs = best
    return (m, 1) if slabs == 1 else (slab, slabs)


class SpmmPlan(NamedTuple):
    """How the spmm kernel adds nnz triplets into an (m_out, k) output.
    ``buckets`` ≤ 1: one pass, ``per_warp`` triplets per warp, no scratch.
    Else the L2-blocked scatter: the triplets are first copied, grouped by
    bucket of ``2**shift`` output rows, into ``scratch_bytes`` of scratch
    (rows, cols, vals: nnz × (4 + 4 + itemsize)) by ``blocks`` blocks,
    then added ``per_warp`` triplets a warp."""
    buckets: int
    shift: int
    per_warp: int
    blocks: int
    scratch_bytes: int


def plan_spmm(nnz: int, m_out: int, k: int, itemsize: int, sm_count: int,
              *, row_major: bool = False,
              bucketed: bool | None = None) -> SpmmPlan:
    """The spmm plan for nnz triplets into (m_out, k) fp32.  By default
    (``bucketed=None``) one pass when the output fits SPMM_L2_SHARE bytes
    (every served batch: b ≤ 256 rows) or when ``row_major`` says the
    triplets of one output row come together (``BlockCOO.row_major``, A·B:
    the reductions then stream through the output, one per row), else the
    L2-blocked scatter with buckets of the most rows, a power of two, whose
    slice of the output fits SPMM_L2_SHARE (k = 50: 2^16 rows, 13.1 MB),
    at most SPMM_MAX_BUCKETS of them.  ``bucketed`` True or False forces
    the choice (to time both ways); an output that one bucket covers, and
    more than 2^31 − 2 triplets (the scratch offsets are int32), always
    take one pass."""
    rows = max(1, SPMM_L2_SHARE // (k * 4))
    shift = rows.bit_length() - 1
    while -(-m_out // (1 << shift)) > SPMM_MAX_BUCKETS:
        shift += 1
    buckets = -(-m_out // (1 << shift))
    one = (bucketed is False or buckets == 1 or nnz == 0
           or nnz >= 2 ** 31 - 1)
    if bucketed is None:
        one = one or row_major or m_out * k * 4 <= SPMM_L2_SHARE
    if one:
        warps = SPMM_WARPS_PER_SM * sm_count
        per_warp = max(32, -(-nnz // warps // 32) * 32)
        return SpmmPlan(1, 0, per_warp, 0, 0)
    return SpmmPlan(buckets, shift, SPMM_BUCKET_RUN,
                    SPMM_BUCKET_BLOCKS_PER_SM * sm_count, nnz * (8 + itemsize))


def vector_width(ptr: int, k: int, itemsize: int) -> int:
    """Elements per gather and reduction of spmm (2 or 1): 2 only when k is
    even and B (at ``ptr``) starts aligned to two elements, so every row of
    B and of the fp32 output starts so aligned."""
    return 2 if k % 2 == 0 and ptr % (2 * itemsize) == 0 else 1


def copy_width(ptr: int, stride: int) -> int:
    """Bytes per asynchronous copy (16 or 4) for rows or panels of
    ``stride`` bytes that start at address ``ptr``: 16 only when every one
    of them starts 16-byte aligned."""
    return 16 if ptr % 16 == 0 and stride % 16 == 0 else 4


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tiles(name: str) -> tuple[int, ...]:
    """The fixed sizes library ``name`` was compiled with, as its
    ``<name>_tiles`` entry point reports them; raises if they are not the
    ones this module plans with (GRAM_TILES, TS_TILES)."""
    if name not in _TILES:
        want = _TILES_EXPECTED[name]
        out = (ctypes.c_int * len(want))()
        getattr(build.load(name), f"{name}_tiles")(out)
        if tuple(out) != want:
            raise RuntimeError(f"{name}: the library reports sizes "
                               f"{tuple(out)}, the wrapper plans with {want}")
        _TILES[name] = tuple(out)
    return _TILES[name]


def _launch(lib, fn: str, name: str, device: torch.device, *args,
            count: bool = True) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"{rc} ({msg})")
    if count:
        LAUNCHES[name] += 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _gram_launcher(X: torch.Tensor):
    """launch(parts, count) -> G for X on CUDA, on the plan, output and slab
    scratch allocated here: the slab kernel (parts 1), the reduction (2) or
    both (3)."""
    r, k = X.shape
    tiles("gram")
    plan = plan_gram(r, k, X.element_size(), _sm_count(X.device))
    vec = copy_width(X.data_ptr(), plan.panel * k * X.element_size()) == 16
    G = torch.empty((k, k), dtype=torch.float32, device=X.device)
    scratch = (torch.empty((plan.slabs, k, k), dtype=torch.float32,
                           device=X.device) if plan.slabs > 1 else None)

    def launch(parts: int = 3, count: bool = True) -> torch.Tensor:
        _launch(build.load("gram"), "gram_launch", "gram", X.device,
                _DTYPE_CODES[X.dtype], X.data_ptr(), G.data_ptr(),
                _ptr(scratch), r, k, plan.slab, plan.slabs, plan.panel,
                int(vec), parts, count=count)
        return G
    return launch


def gram(X: torch.Tensor) -> torch.Tensor:
    """XᵀX (fp32, (k, k)) for X (r, k)."""
    if not _check("gram", X):
        return ref.gram(X)
    return _gram_launcher(X)()


def gram_parts(X: torch.Tensor):
    """The two launches of ``gram(X)`` on a CUDA X, apart, for timing: (slab
    kernel, reduction), zero-argument callables on buffers allocated once,
    counted in no ``LAUNCHES``; each returns the output G, which holds XᵀX
    once both have run.  The reduction launches nothing when the plan has a
    single slab (the slab kernel then writes G itself)."""
    if not _check("gram", X):
        raise ValueError("gram_parts: X must lie on a CUDA device")
    launch = _gram_launcher(X)
    return (lambda: launch(1, False)), (lambda: launch(2, False))


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
    tiles("ts_matmul")
    slab, slabs = plan_ts_matmul(m, n, k, _sm_count(A.device))
    a16 = copy_width(A.data_ptr(), n * A.element_size()) == 16
    C = torch.empty((m, k), dtype=torch.float32, device=A.device)
    scratch = (torch.empty((slabs, m, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    _launch(build.load("ts_matmul"), "ts_matmul_launch", "ts_matmul",
            A.device, _DTYPE_CODES[A.dtype], A.data_ptr(), B.data_ptr(),
            C.data_ptr(), _ptr(scratch), m, n, k, slab, slabs, int(a16),
            int(copy_width(B.data_ptr(), 16) == 16))
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
    tiles("ts_matmul")
    slab, slabs = plan_ts_matmul_t(m, n, k, _sm_count(A.device))
    a16 = copy_width(A.data_ptr(), n * A.element_size()) == 16
    Y = torch.empty((n, k), dtype=torch.float32, device=A.device)
    scratch = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    _launch(build.load("ts_matmul"), "ts_matmul_t_launch", "ts_matmul_t",
            A.device, _DTYPE_CODES[A.dtype], A.data_ptr(), B.data_ptr(),
            Y.data_ptr(), _ptr(scratch), m, n, k, slab, slabs, int(a16),
            int(copy_width(B.data_ptr(), 16) == 16))
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
         B: torch.Tensor, m_out: int, *, row_major: bool = False,
         plan: SpmmPlan | None = None) -> torch.Tensor:
    """A @ B (fp32, (m_out, k)) from COO triplets (duplicates add up) and
    B (n, k): the unsorted kernel, on ``plan`` (default ``plan_spmm``'s;
    ``row_major``: the caller knows the triplets of one row come together,
    as ``BlockCOO.row_major`` records — only the speed depends on it).  Its fp32
    reductions add in an order that changes from run to run, so results
    agree to rounding, not bitwise.  One launch is counted however many
    passes the plan makes."""
    if not _check_sparse("spmm", vals, rows, cols, B, m_out):
        return ref.spmm(vals, rows, cols, B, m_out)
    n, k = B.shape
    nnz, size = vals.numel(), B.element_size()
    if plan is None:
        plan = plan_spmm(nnz, m_out, k, size, _sm_count(B.device),
                         row_major=row_major)
    dev = B.device
    out = torch.empty((m_out, k), dtype=torch.float32, device=dev)
    s_vals = s_rows = s_cols = counts = None
    if plan.buckets > 1:
        s_vals = torch.empty(nnz, dtype=B.dtype, device=dev)
        s_rows = torch.empty(nnz, dtype=torch.int32, device=dev)
        s_cols = torch.empty(nnz, dtype=torch.int32, device=dev)
        counts = torch.empty(plan.buckets * plan.blocks + 1,
                             dtype=torch.int32, device=dev)
    _launch(build.load("spmm"), "spmm_launch", "spmm", dev,
            _DTYPE_CODES[B.dtype], vals.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), B.data_ptr(), out.data_ptr(), nnz, m_out, n, k,
            int(vector_width(B.data_ptr(), k, size) == 2), plan.shift,
            plan.buckets, plan.blocks, plan.per_warp, _ptr(s_vals),
            _ptr(s_rows), _ptr(s_cols), _ptr(counts))
    return out


def spmm_t(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           B: torch.Tensor, n_out: int, *,
           plan: SpmmPlan | None = None) -> torch.Tensor:
    """Aᵀ @ B (fp32, (n_out, k)): the same kernel with rows and cols
    swapped, so Aᵀ is never formed.  Its targets (A's columns) come in no
    order, so the default plan buckets an output beyond the L2 share."""
    return spmm(vals, cols, rows, B, n_out, plan=plan)


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


def luc_max_k() -> int:
    """The largest k the LUC kernels take, as the library reports it."""
    if "luc" not in _TILES:
        out = (ctypes.c_int * 1)()
        build.load("luc").luc_max_k(out)
        _TILES["luc"] = tuple(out)
    return _TILES["luc"][0]


def _check_luc(name: str, X: torch.Tensor, G: torch.Tensor,
               R: torch.Tensor) -> bool:
    """Validate LUC operands: X (r, k) fp32 or bf16, G (k, k) fp32, R (r, k)
    fp32 or X's dtype, all contiguous on one device; on CUDA k is at most
    ``luc_max_k()``.  True on CUDA."""
    for t in (X, G, R):
        if not isinstance(t, torch.Tensor) or t.layout != torch.strided:
            raise TypeError(f"{name}: operands must be dense tensors")
        if t.dim() != 2 or 0 in t.shape:
            raise ValueError(f"{name}: operands must be non-empty 2-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != X.device:
            raise ValueError(f"{name}: operands must share a device, got "
                             f"{X.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    r, k = X.shape
    if tuple(G.shape) != (k, k) or tuple(R.shape) != (r, k):
        raise ValueError(f"{name}: X {tuple(X.shape)} needs G {(k, k)} and "
                         f"R {(r, k)}, got {tuple(G.shape)} and "
                         f"{tuple(R.shape)}")
    if X.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: X must be float32 or bfloat16, got "
                        f"{X.dtype}")
    if G.dtype != torch.float32:
        raise TypeError(f"{name}: G must be float32, got {G.dtype}")
    if R.dtype not in (torch.float32, X.dtype):
        raise TypeError(f"{name}: R must be float32 or X's dtype {X.dtype}, "
                        f"got {R.dtype}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on cpu or cuda, got "
                         f"{X.device}")
    on_cuda = X.device.type == "cuda"
    if on_cuda and k > luc_max_k():
        raise ValueError(f"{name}: the kernel takes k <= {luc_max_k()}, got "
                         f"k = {k}")
    return on_cuda


def _luc(name: str, op: int, X: torch.Tensor, G: torch.Tensor,
         R: torch.Tensor, eps: float) -> torch.Tensor:
    r, k = X.shape
    out = torch.empty_like(X)
    _launch(build.load("luc"), "luc_launch", name, X.device, op,
            _DTYPE_CODES[X.dtype], _DTYPE_CODES[R.dtype], X.data_ptr(),
            G.data_ptr(), R.data_ptr(), out.data_ptr(), r, k, float(eps))
    return out


def mu_update(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor, *,
              eps: float = ref.LUC_EPS) -> torch.Tensor:
    """The fused MU update X ⊙ (R / (X·G + ε)), (r, k) in X's dtype: one
    read of X and R, one write."""
    if not _check_luc("mu_update", X, G, R):
        return ref.mu_update(X, G, R, eps)
    return _luc("mu_update", 0, X, G, R, eps)


def hals_sweep(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor, *,
               eps: float = ref.LUC_EPS) -> torch.Tensor:
    """The sequential HALS column sweep, H-step form, (r, k) in X's dtype:
    column i sees the updated columns 0..i-1; one read of X and R, one
    write."""
    if not _check_luc("hals_sweep", X, G, R):
        return ref.hals_sweep(X, G, R, eps)
    return _luc("hals_sweep", 1, X, G, R, eps)
