"""Wrappers around the port's CUDA kernels — the counterpart of
``repro/kernels/ops.py`` (``gram`` :109, ``ts_matmul`` :153,
``ts_matmul_t`` :174, ``spmm`` :195, ``spmm_t`` :230, ``spmm_sorted`` :254,
``mu_update`` :306, ``hals_sweep`` :319), and ``hals_sweep_norm``, the
HALS W-step's normalised sweep, which the reference leaves to XLA.

Each wrapper

  * checks device, dtype (fp32 or bf16: for ``gram`` and the SpMMs the same
    for every float operand; for ``ts_matmul`` / ``ts_matmul_t`` A's and B's
    independently, as the reference's products promote mixed operands; int32
    indices; for the LUC kernels X fp32 or bf16, G fp32 and R fp32 or X's
    dtype, as the update rules hand them over), shape and contiguity, and
    raises on anything its kernel does not take;
  * on a CPU tensor, runs the plain PyTorch version (``kernels/ref.py``);
  * on a CUDA tensor, allocates the output (and the slab or bucket scratch)
    with ``torch.empty``, launches the kernel on the current stream, raises if
    the launch returned a CUDA error, and adds one to ``LAUNCHES[name]``.
    There is no fallback: a CUDA tensor gets the kernel or an exception;
  * on a fake CUDA tensor or a ``meta`` one (no data: the dry run and
    ``lower_step``), returns an empty output of the kernel's shape and dtype
    and records the call on the open ``roofline.counts`` record, with the
    FLOPs and bytes its bound is computed from (PERF.md §6) and the rate
    its plan runs at.  Nothing is launched and nothing is counted in
    ``LAUNCHES``.  A fake CPU tensor runs the plain version, as a real one
    does.

Unlike the reference, nothing is padded: the kernels mask ragged edges
themselves, so A (56 GB at the paper's Video shape) is never copied.  The
SpMM kernels skip triplets whose indices fall outside the output or B,
as the reference's scatter drops out-of-range updates; the plain versions
raise on them.  The LUC kernels take ε as an argument (default the TPU
kernels' 1e-16; the rules pass ``eps_for(X.dtype)``) and every k, as the
reference's rules do (``mu_update`` on ``plan_mu_update``'s tiles,
``hals_sweep`` on ``plan_hals_sweep``'s, ``hals_sweep_norm`` on
``plan_hals_sweep_norm``'s; past their tiles the latter two run a kernel
of a row at a time).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline.counts import is_fake as _fake, record_kernel

#: launches of each kernel on CUDA tensors since the last reset
#: (``hals_sweep_wide``: hals_sweep's row-per-warp kernel, for the k that
#: no plan of its column-blocked kernel fits; ``ts_matmul_mixed`` /
#: ``ts_matmul_t_mixed``: the products' bf16 A · fp32 B instantiation;
#: ``hals_sweep_norm``: one a sweep, however many passes it launches)
LAUNCHES = {"gram": 0, "ts_matmul": 0, "ts_matmul_t": 0, "ts_matmul_mixed": 0,
            "ts_matmul_t_mixed": 0, "spmm": 0, "spmm_sorted": 0,
            "mu_update": 0, "hals_sweep": 0, "hals_sweep_wide": 0,
            "hals_sweep_norm": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the H100 SXM's SM count, for planning a call on fake tensors (no card
#: to ask)
H100_SM_COUNT = 132
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

#: mu_update: the (rows per tile, ring stages) tried in order; blocks per
#: SM at most; the rows a thread task's RT rows are spread over (RT =
#: rows / MU_ROW_SLICES); an SM's shared memory and what the runtime keeps
#: of it per block.  The row-per-warp LUC kernels: threads and blocks per
#: SM.
MU_LADDER = ((128, 2), (64, 3), (64, 2), (32, 3), (32, 2), (32, 1), (16, 1),
             (8, 1))
MU_BLOCKS_PER_SM = 4
MU_ROW_SLICES = 16
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
LUC_ROWWISE_THREADS = 256
LUC_ROWWISE_BLOCKS_PER_SM = 8
#: hals_sweep: columns per block of the sweep (luc.cu's HB, as luc_tiles
#: reports it); the rows per tile and ring stages its plan chooses from;
#: the threads of a block and of an SM at most (luc.cu's register budget:
#: two blocks of 256 threads, 128 registers a thread); the rows that weigh
#: a tile with G restaged per block of columns as much as its own (its
#: trips to L2 and barriers, paid per tile); the threads an SM should hold
#: at least, and the threads a row that make them up where rows are few
HALS_BLOCK = 16
HALS_ROWS = (256, 128, 64, 32)
HALS_STAGES = (1, 2, 3)
HALS_MAX_THREADS = 256
HALS_THREADS_PER_SM = 512
HALS_RESTAGE_ROWS = 256
HALS_MIN_THREADS_PER_SM = 128
HALS_WIDE_TPR = 4

#: hals_sweep_norm, as luc_tiles reports luc.cu's sizes: columns per
#: block (NB: the width of its column-major scratch panel); the rows of its
#: head pass's tile tried in order (a thread a row; the first is
#: NORM_MAX_THREADS); the threads of its column and tail passes, and of
#: its wide head pass (NORM_THREADS); the blocks of each that an SM holds
#: at most (its register budget: NORM_HEAD_BLOCKS, NORM_COLUMN_BLOCKS)
HALS_NORM_BLOCK = 8
HALS_NORM_ROWS = (128, 64, 32)
HALS_NORM_THREADS = 256
HALS_NORM_HEAD_PER_SM = 8
HALS_NORM_COLUMN_PER_SM = 4

_TILES_EXPECTED = {"gram": GRAM_TILES, "ts_matmul": TS_TILES,
                   "luc": (HALS_BLOCK, HALS_NORM_BLOCK, HALS_NORM_THREADS,
                           HALS_NORM_ROWS[0], HALS_NORM_HEAD_PER_SM,
                           HALS_NORM_COLUMN_PER_SM)}
_TILES: dict[str, tuple[int, ...]] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, *tensors: torch.Tensor, mixed: bool = False) -> bool:
    """Validate operands; True when they lie on a CUDA device (or on
    ``meta``: see ``_fake``).  ``mixed``:
    each operand's dtype is fp32 or bf16 on its own (the dense products);
    otherwise all share one."""
    if not all(isinstance(t, torch.Tensor) and t.layout == torch.strided
               for t in tensors):
        raise TypeError(f"{name}: operands must be dense tensors")
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.dim() != 2 or 0 in t.shape:
            raise ValueError(f"{name}: operands must be non-empty 2-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != dev or (t.dtype != dt and not mixed):
            raise ValueError(f"{name}: operands must share device and dtype, "
                             f"got {dev}/{dt} and {t.device}/{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (pass Hᵀ "
                             f"as a contiguous (n, k) tensor, not H.T)")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: tensors must be on cpu or cuda, got {dev}")
    return dev.type != "cpu"


def _product_rate(dtype: torch.dtype) -> str:
    """The rate class of the tensor-core kernels (gram, the products) on
    operands of ``dtype``: bf16 on bf16 MMAs, fp32 as 3xTF32."""
    return "bfloat16" if dtype == torch.bfloat16 else "tf32x3"


def _recorded(name: str, shape: tuple, dtype: torch.dtype, device,
              flops: float, nbytes: float, rate: str) -> torch.Tensor:
    """The output of a kernel call on fake tensors: recorded on the open
    ``roofline.counts`` record, launched nowhere."""
    record_kernel(name, flops, nbytes, rate, shape)
    return torch.empty(shape, dtype=dtype, device=device)


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
    ones this module plans with (GRAM_TILES, TS_TILES, and for ``luc``
    HALS_BLOCK and hals_sweep_norm's HALS_NORM_* sizes)."""
    if name not in _TILES:
        want = _TILES_EXPECTED[name]
        out = (ctypes.c_int * len(want))()
        getattr(build.load(name), f"{name}_tiles")(out)
        if tuple(out) != want:
            raise RuntimeError(f"{name}: the library reports sizes "
                               f"{tuple(out)}, the wrapper plans with {want}")
        _TILES[name] = tuple(out)
    return _TILES[name]


#: serialises the entry points across threads: gram's and the LUC kernels'
#: set a kernel's dynamic shared-memory limit for the call's plan and then
#: launch it (ctypes releases the GIL in between), so two threads launching
#: one kernel on two plans would otherwise race — a served batch beside an
#: ingest's fold gets "too many resources requested for launch"
_LAUNCH_LOCK = threading.Lock()


def _launch(lib, fn: str, name: str, device: torch.device, *args,
            count: bool = True) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with _LAUNCH_LOCK:
            rc = getattr(lib, fn)(*args, stream)
            if rc == 0 and count:
                LAUNCHES[name] += 1
    if rc != 0:
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error "
                           f"{rc} ({msg})")


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
    if _fake(X):
        # XᵀX is symmetric: k(k+1)/2 distinct entries of r multiply-adds
        r, k = X.shape
        return _recorded("gram", (k, k), torch.float32, X.device,
                         1.0 * r * k * (k + 1), r * k * X.element_size()
                         + k * k * 4, _product_rate(X.dtype))
    return _gram_launcher(X)()


def gram_parts(X: torch.Tensor):
    """The two launches of ``gram(X)`` on a CUDA X, apart, for timing: (slab
    kernel, reduction), zero-argument callables on buffers allocated once,
    counted in no ``LAUNCHES``; each returns the output G, which holds XᵀX
    once both have run.  The reduction launches nothing when the plan has a
    single slab (the slab kernel then writes G itself)."""
    if not _check("gram", X) or _fake(X):
        raise ValueError("gram_parts: X must lie on a CUDA device")
    launch = _gram_launcher(X)
    return (lambda: launch(1, False)), (lambda: launch(2, False))


def _product_b(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """B as the product kernel takes it beside A: as it is, or, for an fp32
    A with a bf16 B, widened to fp32 (exact; B is the tall-skinny n × k or
    m × k factor, never the data matrix), so fp32 · fp32 runs.  A itself is
    never widened: a bf16 A with an fp32 B runs the mixed instantiation."""
    if A.dtype == torch.float32 and B.dtype == torch.bfloat16:
        return B.float()
    return B


def _product_name(name: str, A: torch.Tensor, B: torch.Tensor) -> str:
    """The LAUNCHES key of a product launch: ``<name>_mixed`` for bf16 A ·
    fp32 B."""
    return name if A.dtype == B.dtype else f"{name}_mixed"


def ts_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B (fp32, (m, k)) for A (m, n), B (n, k), each fp32 or bf16."""
    on_cuda = _check("ts_matmul", A, B, mixed=True)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"ts_matmul: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} do not chain")
    if not on_cuda:
        return ref.ts_matmul(A, B)
    B = _product_b(A, B)
    m, n = A.shape
    k = B.shape[1]
    if _fake(A):
        return _recorded(_product_name("ts_matmul", A, B), (m, k),
                         torch.float32, A.device, 2.0 * m * n * k,
                         m * n * A.element_size() + n * k * B.element_size()
                         + m * k * 4, _product_rate(B.dtype))
    tiles("ts_matmul")
    slab, slabs = plan_ts_matmul(m, n, k, _sm_count(A.device))
    a16 = copy_width(A.data_ptr(), n * A.element_size()) == 16
    C = torch.empty((m, k), dtype=torch.float32, device=A.device)
    scratch = (torch.empty((slabs, m, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    _launch(build.load("ts_matmul"), "ts_matmul_launch",
            _product_name("ts_matmul", A, B), A.device,
            _DTYPE_CODES[A.dtype], _DTYPE_CODES[B.dtype], A.data_ptr(),
            B.data_ptr(), C.data_ptr(), _ptr(scratch), m, n, k, slab, slabs,
            int(a16), int(copy_width(B.data_ptr(), 16) == 16))
    return C


def ts_matmul_t(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ B (fp32, (n, k)) for A (m, n), B (m, k), each fp32 or bf16,
    without transposing A."""
    on_cuda = _check("ts_matmul_t", A, B, mixed=True)
    if A.shape[0] != B.shape[0]:
        raise ValueError(f"ts_matmul_t: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} do not share rows")
    if not on_cuda:
        return ref.ts_matmul_t(A, B)
    B = _product_b(A, B)
    m, n = A.shape
    k = B.shape[1]
    if _fake(A):
        return _recorded(_product_name("ts_matmul_t", A, B), (n, k),
                         torch.float32, A.device, 2.0 * m * n * k,
                         m * n * A.element_size() + m * k * B.element_size()
                         + n * k * 4, _product_rate(B.dtype))
    tiles("ts_matmul")
    slab, slabs = plan_ts_matmul_t(m, n, k, _sm_count(A.device))
    a16 = copy_width(A.data_ptr(), n * A.element_size()) == 16
    Y = torch.empty((n, k), dtype=torch.float32, device=A.device)
    scratch = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    _launch(build.load("ts_matmul"), "ts_matmul_t_launch",
            _product_name("ts_matmul_t", A, B), A.device,
            _DTYPE_CODES[A.dtype], _DTYPE_CODES[B.dtype], A.data_ptr(),
            B.data_ptr(), Y.data_ptr(), _ptr(scratch), m, n, k, slab, slabs,
            int(a16), int(copy_width(B.data_ptr(), 16) == 16))
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
    if _fake(B):
        # the triplets once, the dense operand once, the output once
        return _recorded("spmm", (m_out, k), torch.float32, B.device,
                         2.0 * nnz * k, nnz * (size + 8) + n * k * size
                         + m_out * k * 4, "float32")
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


def first_units(tiles: torch.Tensor, ntiles: int) -> torch.Tensor:
    """Each 8-row tile's first unit of a packed layout, (ntiles + 1,) int32
    on ``tiles``' device: tile t owns units [first[t], first[t + 1]).
    ``tiles`` (U,) is non-decreasing; (B, U) gives (B, ntiles + 1), a row
    per block."""
    want = torch.arange(ntiles + 1, dtype=tiles.dtype, device=tiles.device)
    if tiles.dim() == 2:
        want = want.expand(tiles.shape[0], -1).contiguous()
    return torch.searchsorted(tiles.contiguous(), want, out_int32=True)


def rows_in_order(rows: torch.Tensor, cols: torch.Tensor,
                  tiles: torch.Tensor, valid: torch.Tensor, m_out: int,
                  n: int, *, align: int) -> bool:
    """Whether, within each 8-row tile of a packed layout, the live slots
    (valid, with the row in the tile and the column in [0, n)) come in
    non-decreasing row order, as ``spmm_sorted``'s kernel needs.  The tiles
    are non-decreasing and a tile's rows lie below the next tile's, so that
    holds when the live rows, read in packed order, never decrease."""
    U = tiles.numel()
    r = rows.reshape(U, align)
    lo = tiles.reshape(U, 1).long() * 8
    c = cols.reshape(U, align)
    live = ((torch.arange(align, device=tiles.device) < valid.reshape(U, 1))
            & (r >= lo) & (r < torch.clamp(lo + 8, max=m_out))
            & (c >= 0) & (c < n))
    rr = r[live]
    return bool((rr[1:] >= rr[:-1]).all())


def spmm_sorted(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                tiles: torch.Tensor, valid: torch.Tensor, B: torch.Tensor,
                m_out: int, *, align: int,
                first: torch.Tensor | None = None) -> torch.Tensor:
    """A @ B (fp32, (m_out, k)) from the ``sort_rows`` packed layout:
    ``vals``/``rows``/``cols`` of U·align slots, and per unit its 8-row
    tile id (non-decreasing, < ceil(m_out/8)) and valid count; within a
    tile the valid slots come in row order.  ``first``: each tile's first
    unit (``first_units``; ``BlockCOO.row_first``/``col_first`` keep it),
    computed here when not given.  Each output row is summed in packed
    order by one warp and written once; rows that own no triplets come out
    0.  No atomics: repeated runs are bit-identical.  The kernel mis-sums a
    tile whose rows are out of order, so on CUDA a layout given without
    ``first`` (not one of ``sort_rows``') is checked (``rows_in_order``)
    and refused with ValueError; the plain version on the CPU takes any
    order."""
    extra = () if first is None else (first,)
    on_cuda = _check_sparse("spmm_sorted", vals, rows, cols, B, m_out,
                            tiles, valid, *extra)
    if align <= 0 or vals.numel() != tiles.numel() * align:
        raise ValueError(f"spmm_sorted: {vals.numel()} packed slots are not "
                         f"{tiles.numel()} units of align={align}")
    if valid.numel() != tiles.numel():
        raise ValueError(f"spmm_sorted: {valid.numel()} valid counts for "
                         f"{tiles.numel()} units")
    ntiles = -(-m_out // 8)
    if first is not None and first.numel() != ntiles + 1:
        raise ValueError(f"spmm_sorted: {first.numel()} first units for "
                         f"{ntiles} tiles (need {ntiles + 1})")
    if not on_cuda:
        return ref.spmm_sorted(vals, rows, cols, tiles, valid, B, m_out,
                               align=align)
    n, k = B.shape
    if _fake(B):
        slots, size = vals.numel(), B.element_size()
        return _recorded("spmm_sorted", (m_out, k), torch.float32, B.device,
                         2.0 * slots * k, slots * (size + 8) + n * k * size
                         + m_out * k * 4, "float32")
    if first is None:
        if not rows_in_order(rows, cols, tiles, valid, m_out, n,
                             align=align):
            raise ValueError("spmm_sorted: a tile's slots are not in row "
                             "order (sort_rows makes that layout)")
        first = first_units(tiles, ntiles)
    out = torch.empty((m_out, k), dtype=torch.float32, device=B.device)
    _launch(build.load("spmm"), "spmm_sorted_launch", "spmm_sorted",
            B.device, _DTYPE_CODES[B.dtype], vals.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), first.data_ptr(),
            valid.data_ptr(), B.data_ptr(), out.data_ptr(), ntiles, m_out, n,
            k, align,
            int(vector_width(B.data_ptr(), k, B.element_size()) == 2))
    return out


class MuPlan(NamedTuple):
    """How mu_update_kernel walks X (r, k): persistent ``blocks`` take
    tiles of ``rows`` rows (thread tasks of ``rt`` rows × 4 columns)
    through a ring of ``stages`` stages, with G staged in column chunks of
    ``chunk`` (k: all of G, once per block); ``direct``: an fp32 X is read
    where it lands, with no fp32 copy; ``smem`` bytes of shared memory a
    block.  ``rows`` = 0: the row-per-warp kernel (a k whose G and one
    8-row tile exceed shared memory) on ``blocks`` blocks."""
    rows: int
    stages: int
    chunk: int
    rt: int
    blocks: int
    smem: int
    direct: bool = False

    def launch_args(self, vec: bool) -> tuple[int, ...]:
        """luc_launch's (rows, stages, chunk, rt, blocks, vec, direct)."""
        return (self.rows, self.stages, self.chunk, self.rt, self.blocks,
                int(vec), int(self.direct))


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def mu_smem(k: int, rows: int, stages: int, chunk: int, itemsize: int,
            r_itemsize: int, direct: bool = False) -> int:
    """Shared memory of mu_update_kernel (luc.cu's mu_layout): G's chunk
    (k × the chunk rounded up to 4), X's fp32 panel (rows × (k | 1); none
    when ``direct``), and per stage the X and R panels as they arrive (a
    lead-in of up to 16 bytes each)."""
    kcp = -(-chunk // 4) * 4
    stage = (_align16(rows * k * itemsize + 16)
             + _align16(rows * k * r_itemsize + 16))
    xf = 0 if direct else _align16(rows * (k | 1) * 4)
    return _align16(k * kcp * 4) + xf + stages * stage


def _rowwise_blocks(r: int, sm_count: int) -> int:
    """Blocks of the row-per-warp LUC kernels: a warp per row, at most
    LUC_ROWWISE_BLOCKS_PER_SM per SM."""
    return max(1, min(-(-r // (LUC_ROWWISE_THREADS // 32)),
                      LUC_ROWWISE_BLOCKS_PER_SM * sm_count))


def _mu_blocks_per_sm(smem: int) -> int:
    return min(MU_BLOCKS_PER_SM,
               SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))


def plan_mu_update(r: int, k: int, itemsize: int, sm_count: int, *,
                   r_itemsize: int = 4) -> MuPlan:
    """The first (rows, stages) of MU_LADDER with a ring of two or more
    stages whose ring, X panel and whole G fit two blocks on an SM, else
    the first that fits one; else the first whose ring and X
    panel leave room for a G chunk of at least 4 columns (the widest
    multiple of 4 that fits); else the row-per-warp kernel.  An fp32 X with
    gcd(k, 32) ≤ 2 is read where it lands (``direct``: its rows fall in
    distinct banks).  Blocks: as many as fit an SM's shared memory, at most
    MU_BLOCKS_PER_SM, times ``sm_count``, and no more than the tiles.
    ``itemsize`` is X's, ``r_itemsize`` R's (fp32 by default)."""
    direct = itemsize == 4 and math.gcd(k, 32) <= 2

    def smem(t, s, chunk):
        return mu_smem(k, t, s, chunk, itemsize, r_itemsize, direct)
    choice = None
    for least, ring in ((2, 2), (1, 1)):
        for t, s in MU_LADDER:
            if (choice is None and s >= ring
                    and _mu_blocks_per_sm(smem(t, s, k)) >= least):
                choice = (t, s, k)
    if choice is None:
        for t, s in MU_LADDER:
            rest = SMEM_PER_BLOCK - smem(t, s, 0)
            chunk = max(0, rest) // (16 * k) * 4
            if chunk >= 4:
                choice = (t, s, min(chunk, k))
                break
    if choice is None:
        return MuPlan(0, 0, 0, 0, _rowwise_blocks(r, sm_count), 0)
    t, s, chunk = choice
    size = smem(t, s, chunk)
    rt = max(1, min(8, t // MU_ROW_SLICES))
    blocks = max(1, min(-(-r // t),
                        max(1, _mu_blocks_per_sm(size)) * sm_count))
    return MuPlan(t, s, chunk, rt, blocks, size, direct)


class HalsPlan(NamedTuple):
    """How hals_sweep_kernel walks X (r, k): persistent ``blocks`` of rows ·
    tpr threads take tiles of ``rows`` rows (``tpr`` threads a row, for the
    whole sweep, each owning 16 / tpr columns of a block) through a ring of
    ``stages`` stages, with ``gblocks`` column blocks of G in shared memory
    (all of them, staged once per block; or 1, restaged per block of
    columns); ``direct``: an fp32 X is swept where it lands, with no fp32
    copy; ``smem`` bytes of shared memory a block.  ``rows`` = 0: the
    row-per-warp kernel (a k whose smallest tile does not fit) on
    ``blocks`` blocks.  Every plan gives the same bits."""
    rows: int
    stages: int
    gblocks: int
    tpr: int
    blocks: int
    smem: int
    direct: bool = False

    def launch_args(self, vec: bool) -> tuple[int, ...]:
        """luc_launch's (rows, stages, chunk, rt, blocks, vec, direct): its
        chunk and rt slots carry gblocks and tpr for op 1."""
        return (self.rows, self.stages, self.gblocks, self.tpr, self.blocks,
                int(vec), int(self.direct))


def hals_smem(k: int, rows: int, stages: int, gblocks: int, itemsize: int,
              r_itemsize: int, direct: bool = False) -> int:
    """Shared memory of hals_sweep_kernel (luc.cu's hals_layout): the
    column blocks of G (k × HALS_BLOCK floats each), the k reciprocals of
    G's diagonal, X's fp32 panel (rows × (k | 1); none when ``direct``),
    and per stage the X and R panels as they arrive (a lead-in of up to 16
    bytes each)."""
    stage = (_align16(rows * k * itemsize + 16)
             + _align16(rows * k * r_itemsize + 16))
    xf = 0 if direct else _align16(rows * (k | 1) * 4)
    return (_align16(gblocks * k * HALS_BLOCK * 4) + _align16(k * 4) + xf
            + stages * stage)


def _hals_blocks_per_sm(smem: int, threads: int) -> int:
    return min(HALS_THREADS_PER_SM // threads,
               SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))


@functools.lru_cache(maxsize=256)
def plan_hals_sweep(r: int, k: int, itemsize: int, sm_count: int, *,
                    r_itemsize: int = 4) -> HalsPlan:
    """Of the tiles (HALS_ROWS rows, no more than r rounded up to 32;
    HALS_STAGES stages; G whole or restaged per block of columns) that fit
    shared memory, the one with the most rows resident on an SM (a thread
    a row: the sweep's serial chains need many in flight), a restaged G's
    rows weighed by rows / (rows + HALS_RESTAGE_ROWS); then the most
    stages and rows.  Where that leaves fewer than HALS_MIN_THREADS_PER_SM
    threads on an SM (a wide k: G and a row of X and R fill shared memory),
    HALS_WIDE_TPR threads share each row.  None (a k whose 32-row tile, one
    stage and one column block of G exceed shared memory): the row-per-warp
    kernel.  An fp32 X with gcd(k, 32) ≤ 2 is swept where it lands
    (``direct``: 32 rows at stride k fall in 16 or 32 banks).  Blocks: as
    many as fit an SM, times ``sm_count``, and no more than the tiles.
    ``itemsize`` is X's, ``r_itemsize`` R's (fp32 by default).  Cached: a
    fold-in calls it once a sweep."""
    direct = itemsize == 4 and math.gcd(k, 32) <= 2
    nb = -(-k // HALS_BLOCK)
    best, score = None, None
    for rows in HALS_ROWS:
        if rows > max(32, -(-r // 32) * 32):
            continue
        for stages in HALS_STAGES:
            for gblocks in dict.fromkeys((nb, 1)):
                smem = hals_smem(k, rows, stages, gblocks, itemsize,
                                 r_itemsize, direct)
                per_sm = _hals_blocks_per_sm(smem, rows)
                if smem > SMEM_PER_BLOCK or per_sm < 1:
                    continue
                weight = per_sm * rows
                if gblocks < nb:
                    weight *= rows / (rows + HALS_RESTAGE_ROWS)
                if score is None or (weight, stages, rows) > score:
                    best, score = (rows, stages, gblocks, smem), (
                        weight, stages, rows)
    if best is None:
        return HalsPlan(0, 0, 0, 0, _rowwise_blocks(r, sm_count), 0)
    rows, stages, gblocks, smem = best
    tpr = 1
    if _hals_blocks_per_sm(smem, rows) * rows < HALS_MIN_THREADS_PER_SM:
        tpr = HALS_WIDE_TPR
    per_sm = _hals_blocks_per_sm(smem, rows * tpr)
    blocks = max(1, min(-(-r // rows), per_sm * sm_count))
    return HalsPlan(rows, stages, gblocks, tpr, blocks, smem, direct)


def _check_luc(name: str, X: torch.Tensor, G: torch.Tensor,
               R: torch.Tensor) -> bool:
    """Validate LUC operands: X (r, k) fp32 or bf16, G (k, k) fp32, R (r, k)
    fp32 or X's dtype, all contiguous on one device.  Any k.  True on
    CUDA."""
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
    if X.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: tensors must be on cpu or cuda, got "
                         f"{X.device}")
    return X.device.type != "cpu"


def _luc(name: str, op: int, X: torch.Tensor, G: torch.Tensor,
         R: torch.Tensor, eps: float,
         plan: MuPlan | HalsPlan | None = None) -> torch.Tensor:
    r, k = X.shape
    if _fake(X):
        # X and R read once, G once, the result written once; X·G's
        # multiply-adds.  The plan (on the H100's SM count) names the
        # kernel: a k no tile of hals_sweep fits runs the row-per-warp one.
        sx, sr = X.element_size(), R.element_size()
        if op == 1 and plan is None:
            plan = plan_hals_sweep(r, k, sx, H100_SM_COUNT, r_itemsize=sr)
        if op == 1 and plan.rows == 0:
            name = "hals_sweep_wide"
        return _recorded(name, (r, k), X.dtype, X.device, 2.0 * r * k * k,
                         r * k * (2 * sx + sr) + k * k * 4, "float32")
    tiles("luc")
    out = torch.empty_like(X)
    sms = _sm_count(X.device)
    scratch = None
    if plan is None:
        planner = plan_mu_update if op == 0 else plan_hals_sweep
        plan = planner(r, k, X.element_size(), sms,
                       r_itemsize=R.element_size())
    if op == 1 and plan.rows == 0:
        name = "hals_sweep_wide"
        scratch = torch.empty((k, k), dtype=torch.float32, device=X.device)
    vec = (plan.rows > 0 and all(
        copy_width(t.data_ptr(), plan.rows * k * t.element_size()) == 16
        for t in (X, R)))
    args = plan.launch_args(vec)
    _launch(build.load("luc"), "luc_launch", name, X.device, op,
            _DTYPE_CODES[X.dtype], _DTYPE_CODES[R.dtype], X.data_ptr(),
            G.data_ptr(), R.data_ptr(), out.data_ptr(), _ptr(scratch), r, k,
            float(eps), *args)
    return out


def mu_update(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor, *,
              eps: float = ref.LUC_EPS,
              plan: MuPlan | None = None) -> torch.Tensor:
    """The fused MU update X ⊙ (R / (X·G + ε)), (r, k) in X's dtype, any k:
    one read of X and R, one write, on ``plan`` (default
    ``plan_mu_update``'s)."""
    if not _check_luc("mu_update", X, G, R):
        return ref.mu_update(X, G, R, eps)
    return _luc("mu_update", 0, X, G, R, eps, plan)


def hals_sweep(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor, *,
               eps: float = ref.LUC_EPS,
               plan: HalsPlan | None = None) -> torch.Tensor:
    """The sequential HALS column sweep, H-step form, (r, k) in X's dtype,
    any k: column i sees the updated columns 0..i-1; one read of X and R,
    one write, on ``plan`` (default ``plan_hals_sweep``'s; a k no tile fits
    runs the row-per-warp kernel, with a k × k scratch for Gᵀ, counted as
    ``hals_sweep_wide``)."""
    if not _check_luc("hals_sweep", X, G, R):
        return ref.hals_sweep(X, G, R, eps)
    return _luc("hals_sweep", 1, X, G, R, eps, plan)


class HalsNormPlan(NamedTuple):
    """How hals_sweep_norm's passes walk X (r, k): each head pass on
    ``head_blocks`` persistent blocks of ``rows`` threads (a row each;
    ``rows`` 0: the wide head pass, a thread a row on blocks of
    HALS_NORM_THREADS), each column and tail pass on ``col_blocks`` blocks
    of HALS_NORM_THREADS (a row a thread, grid-stride).  The bits depend
    on the plan (the blocks' sums of squares), and repeat on it."""
    rows: int
    head_blocks: int
    col_blocks: int


def hals_norm_smem(k: int, rows: int) -> int:
    """Shared memory of hals_sweep_norm's head pass (luc.cu's norm_layout):
    G's block of columns (k × HALS_NORM_BLOCK floats), the previous block's
    divisors, a float a warp, the tile's block of R (rows at stride
    HALS_NORM_BLOCK + 1) and of Q (HALS_NORM_BLOCK columns of rows), and
    the tile's rows in fp32 at stride k | 1."""
    nb = HALS_NORM_BLOCK
    return (_align16(k * nb * 4) + _align16(nb * 4)
            + _align16(HALS_NORM_ROWS[0] // 32 * 4)
            + _align16(rows * (nb + 1) * 4) + _align16(nb * rows * 4)
            + _align16(rows * (k | 1) * 4))


def hals_norm_rows(k: int) -> int:
    """The head pass's rows a tile: the first of HALS_NORM_ROWS whose
    shared memory fits a block, 0 where none does (k > 1,438: the wide
    head pass)."""
    for rows in HALS_NORM_ROWS:
        if hals_norm_smem(k, rows) <= SMEM_PER_BLOCK:
            return rows
    return 0


@functools.lru_cache(maxsize=256)
def plan_hals_sweep_norm(r: int, k: int, sm_count: int) -> HalsNormPlan:
    """The head pass on ``hals_norm_rows(k)`` rows a tile, as many blocks
    as an SM holds (HALS_NORM_HEAD_PER_SM, fewer where shared memory runs
    out) times ``sm_count``, and no more than the tiles; the column and
    tail passes, and a wide head pass (``rows`` 0), on
    HALS_NORM_COLUMN_PER_SM blocks an SM, times ``sm_count``, and no more
    than cover r.  All resident at once: one wave."""
    col = max(1, min(-(-r // HALS_NORM_THREADS),
                     HALS_NORM_COLUMN_PER_SM * sm_count))
    rows = hals_norm_rows(k)
    if rows == 0:
        return HalsNormPlan(0, col, col)
    per_sm = min(HALS_NORM_HEAD_PER_SM, SMEM_PER_SM // (
        hals_norm_smem(k, rows) + SMEM_RESERVED_PER_BLOCK))
    head = max(1, min(-(-r // rows), per_sm * sm_count))
    return HalsNormPlan(rows, head, col)


def hals_sweep_norm(X: torch.Tensor, G: torch.Tensor, R: torch.Tensor, *,
                    eps: float = ref.LUC_EPS,
                    plan: HalsNormPlan | None = None) -> torch.Tensor:
    """The sequential HALS column sweep, W-step form, each new column
    normalised over all r rows (``ref.hals_sweep_norm``), (r, k) in X's
    dtype, any k: k + 1 passes from one host call, on ``plan`` (default
    ``plan_hals_sweep_norm``'s; ``rows`` 0 takes the wide head pass at any
    k), with an (HALS_NORM_BLOCK, r) fp32 scratch panel."""
    if not _check_luc("hals_sweep_norm", X, G, R):
        return ref.hals_sweep_norm(X, G, R, eps)
    r, k = X.shape
    if _fake(X):
        # counted as the other LUC kernels: X and R read once, G once, the
        # result written once; X·G's multiply-adds
        sx, sr = X.element_size(), R.element_size()
        return _recorded("hals_sweep_norm", (r, k), X.dtype, X.device,
                         2.0 * r * k * k, r * k * (2 * sx + sr) + k * k * 4,
                         "float32")
    tiles("luc")
    dev = X.device
    plan = plan or plan_hals_sweep_norm(r, k, _sm_count(dev))
    out = torch.empty_like(X)
    Q = torch.empty((HALS_NORM_BLOCK, r), dtype=torch.float32, device=dev)
    part = torch.empty((k, max(plan.head_blocks, plan.col_blocks)),
                       dtype=torch.float32, device=dev)
    dsc = torch.empty(k, dtype=torch.float32, device=dev)
    _launch(build.load("luc"), "hals_norm_launch", "hals_sweep_norm", dev,
            _DTYPE_CODES[X.dtype], _DTYPE_CODES[R.dtype], X.data_ptr(),
            G.data_ptr(), R.data_ptr(), out.data_ptr(), Q.data_ptr(),
            part.data_ptr(), dsc.data_ptr(), r, k, float(eps), plan.rows,
            plan.head_blocks, plan.col_blocks)
    return out
