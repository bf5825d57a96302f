"""The plans and the numerics of the port's gram and ts_matmul kernels,
without a GPU.

The kernels (``kernels/csrc/gram.cu``, ``kernels/csrc/ts_matmul.cu``) take
their grids from plans computed in Python (``kernels/ops.py``): a persistent
grid of row slabs for gram, and a split contraction for ts_matmul when its
output cannot fill the card.  ts_matmul multiplies fp32 on the tensor cores
as three TF32 products (3xTF32).  Here the plans are checked for coverage
and size, and a numpy model of the 3xTF32 split is held against float64 and
against the JAX package's plain ``ts_matmul`` on the parity inputs.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

H100_SMS = 132
SERVE_N = 1_013_400          # Video's rows: a served column batch's width
VIDEO_N = 13_824
# The shapes of tests/test_kernels.py.
SHAPES = [(64, 48, 8), (96, 128, 16), (100, 70, 10), (128, 64, 50),
          (32, 256, 4)]


@pytest.mark.parametrize("m", [1_013_400, 528 * 128, 2_000_000])
def test_ts_matmul_plan_keeps_one_slab_when_tiles_fill_the_card(m):
    bm, bn, _, _ = ops.TS_TILES
    slab, slabs = ops.plan_ts_matmul(m, VIDEO_N, 50, H100_SMS)
    assert (slab, slabs) == (VIDEO_N, 1)
    assert -(-m // bm) * -(-50 // bn) >= ops.TS_SPLIT_BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("k", [1, 50, 64, 70, 128])
def test_ts_matmul_plan_splits_a_short_wide_product(b, k):
    bm, bn, bk, _ = ops.TS_TILES
    slab, slabs = ops.plan_ts_matmul(b, SERVE_N, k, H100_SMS)
    tiles = -(-b // bm) * -(-k // bn)
    assert slab % bk == 0 and slab >= 4 * bk
    assert (slabs - 1) * slab < SERVE_N <= slabs * slab
    assert tiles * slabs >= H100_SMS
    assert slabs <= 65535


@pytest.mark.parametrize("r", [13_824, 1_013_400, 1 << 24])
@pytest.mark.parametrize("k", [1, 50, 56, 64, 70, 128])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_gram_plan_is_a_persistent_grid_covering_the_rows(r, k, itemsize):
    stages, sup, _ = ops.GRAM_TILES
    plan = ops.plan_gram(r, k, itemsize, H100_SMS)
    assert plan.slab % plan.panel == 0
    assert (plan.slabs - 1) * plan.slab < r <= plan.slabs * plan.slab
    assert plan.pairs == (-(-k // sup)) * (-(-k // sup) + 1) // 2
    # about two blocks per SM in all, and never shorter than the minimum
    assert plan.slabs * plan.pairs <= ops.GRAM_BLOCKS_PER_SM * H100_SMS
    assert plan.slabs == 1 or plan.slab >= ops.GRAM_MIN_SLAB
    # a panel is about GRAM_PANEL_BYTES, an 8-row step for each warp
    assert plan.panel % 32 == 0 and plan.panel <= 128
    assert plan.panel * k * itemsize <= ops.GRAM_PANEL_BYTES
    if r == 13_824:
        assert plan.slabs <= r // ops.GRAM_MIN_SLAB    # a handful of blocks


def test_gram_plan_refuses_a_k_the_ring_cannot_hold():
    with pytest.raises(ValueError, match="too wide"):
        ops.plan_gram(1000, 20_000, 4, H100_SMS)
    with pytest.raises(ValueError, match="too wide"):
        ops.plan_gram(1000, 4096, 4, H100_SMS)
    assert ops.plan_gram(1000, 1024, 4, H100_SMS).panel == 8


@pytest.mark.parametrize("ptr,stride,width", [
    (0x7f0000000000, 13_824 * 4, 16),     # Video's A rows: 16-byte copies
    (0x7f0000000000, 50 * 4, 4),          # a row of k = 50 fp32: 200 bytes
    (0x7f0000000004, 1024, 4),            # a view off the 16-byte grid
    (0x7f0000000000, 1003 * 4, 4),        # n not a multiple of 4
    (0x7f0000000000, 1008 * 2, 16)])
def test_copy_width_is_16_only_when_every_row_is_aligned(ptr, stride, width):
    assert ops.copy_width(ptr, stride) == width


# ---------------------------------------------------------------------------
# A numpy model of 3xTF32
# ---------------------------------------------------------------------------

def _tf32_round(x: np.ndarray) -> np.ndarray:
    """x rounded to tf32 (10 mantissa bits): add half of the 13 dropped
    bits' range and clear them, as the kernel's tf32_big does."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_read(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of an fp32 register: the top 10 mantissa
    bits (the low 13 are ignored)."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x: np.ndarray):
    big = _tf32_round(x)
    small = (x.astype(np.float32) - big).astype(np.float32)
    return big, _tf32_read(small)


def _three_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernel forms it: the three TF32 products, each exact,
    summed in float64 (the model leaves the summation order out)."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    f = np.float64
    return (ab.astype(f) @ bb.astype(f) + ab.astype(f) @ bs.astype(f)
            + as_.astype(f) @ bb.astype(f))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_tf32_split_rebuilds_fp32_within_2_to_the_minus_22(m, n, k):
    a, b = _inputs(11, (m, n), (n, k))
    for x in (a, b, -a, a * 1e-20, a * 1e20):
        big, small = _split(x)
        # big has at most 11 significant bits, so it is exact in tf32
        assert np.array_equal(_tf32_read(big), big)
        err = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
        assert err.max() <= 2.0 ** -22


def test_tf32_split_keeps_bf16_exact():
    x = _inputs(12, (64, 64))[0]
    x16 = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    big, small = _split(x16)
    assert np.array_equal(big, x16) and not small.any()


@pytest.mark.parametrize("m,n,k", SHAPES + [(300, 13_824, 50)])
def test_three_tf32_products_meet_the_fp32_tolerance(m, n, k):
    """The 3-term product against float64 and against the JAX package's
    plain ts_matmul (fp32), at the scaled 1e-5 of test_kernels.py; one TF32
    product alone does not meet it."""
    a, b = _inputs(13, (m, n), (n, k))
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = _three_tf32(a, b)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale <= 1e-5
    jax_out = np.asarray(jref.ts_matmul(jnp.asarray(a), jnp.asarray(b)),
                         np.float64)
    assert np.abs(got - jax_out).max() / scale <= 1e-5
    one = (_tf32_round(a).astype(np.float64) @ _tf32_round(b).astype(np.float64))
    assert np.abs(one - want).max() / scale > 1e-5


# ---------------------------------------------------------------------------
# ts_matmul_t's split contraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1_013_400, 528 * 128, 50),
                                   (100_000, 1_000_000, 8), (64, 13_824, 50),
                                   (20, 300, 1)])
def test_ts_matmul_t_plan_keeps_one_slab_when_tiles_fill_the_card(m, n, k):
    bm, bn, _, _ = ops.TS_TILES
    tiles = -(-n // bm) * -(-k // bn)
    slab, slabs = ops.plan_ts_matmul_t(m, n, k, H100_SMS)
    assert slabs == 1 and slab >= m
    assert tiles >= ops.TS_SPLIT_BLOCKS_PER_SM * H100_SMS or m <= 4 * 32


@pytest.mark.parametrize("m", [129, 4_099, 65_536, 1_013_400, 1 << 31])
@pytest.mark.parametrize("n,k", [(VIDEO_N, 50), (1_001, 70), (130, 128),
                                 (1, 1)])
def test_ts_matmul_t_plan_splits_m_into_bk_slabs(m, n, k):
    bm, bn, bk, _ = ops.TS_TILES
    tiles = -(-n // bm) * -(-k // bn)
    slab, slabs = ops.plan_ts_matmul_t(m, n, k, H100_SMS)
    assert 1 <= slabs <= ops._MAX_SLABS
    # the slabs cover m, only the last ragged
    assert (slabs - 1) * slab < m <= slabs * slab
    if slabs > 1:
        assert slab % bk == 0 and slab >= 4 * bk
        # about enough blocks for the card (slab rounds up to a BK
        # multiple), unless the slabs would be too short
        assert (tiles * slabs >= 0.9 * ops.TS_SPLIT_BLOCKS_PER_SM * H100_SMS
                or slabs >= -(-m // (4 * bk)) - 1
                or slabs == ops._MAX_SLABS)


def test_ts_matmul_t_plan_avoids_a_short_last_wave_at_video():
    slab, slabs = ops.plan_ts_matmul_t(1_013_400, VIDEO_N, 50, H100_SMS)
    blocks = 108 * slabs
    slots = ops.TS_RESIDENT_PER_SM * H100_SMS
    # the last wave of resident blocks is at least 90 % full
    assert blocks % slots == 0 or blocks % slots >= 0.9 * slots
    assert blocks >= ops.TS_SPLIT_BLOCKS_PER_SM * H100_SMS


# ---------------------------------------------------------------------------
# spmm's plan and a model of its L2-blocked scatter
# ---------------------------------------------------------------------------

SPARSE_DIM = 1 << 24
WEBBASE_NNZ = 144_835_113


@pytest.mark.parametrize("m_out,k,nnz", [
    (1, 50, 9), (256, 50, 2_210), (256, 128, 10_000), (7, 1, 3),
    (SPARSE_DIM, 50, WEBBASE_NNZ), (83_886, 50, 10_000)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_spmm_plan_is_one_pass_when_the_output_fits_or_rows_run(
        m_out, k, nnz, itemsize):
    fits = m_out * k * 4 <= ops.SPMM_L2_SHARE
    for row_major in (False, True):
        plan = ops.plan_spmm(nnz, m_out, k, itemsize, H100_SMS,
                             row_major=row_major)
        if fits or row_major:
            assert plan.buckets == 1 and plan.scratch_bytes == 0
            assert plan.per_warp % 32 == 0
            # the warps of the single pass cover every triplet
            assert plan.per_warp * ops.SPMM_WARPS_PER_SM * H100_SMS >= nnz
        else:
            assert plan.buckets > 1
    forced = ops.plan_spmm(nnz, m_out, k, itemsize, H100_SMS, bucketed=False)
    assert forced.buckets == 1 and forced.scratch_bytes == 0


@pytest.mark.parametrize("m_out", [83_887, 1 << 20, SPARSE_DIM, 10 ** 9])
@pytest.mark.parametrize("k", [1, 50, 51, 128, 4_096])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_spmm_plan_buckets_cover_every_output_row_once(m_out, k, itemsize):
    nnz = 1_000_003
    plan = ops.plan_spmm(nnz, m_out, k, itemsize, H100_SMS, bucketed=True)
    if plan.buckets == 1:       # one bucket would hold the whole output
        assert m_out * k * 4 <= ops.SPMM_L2_SHARE and plan.scratch_bytes == 0
        return
    size = 1 << plan.shift
    # buckets of 2**shift rows: together every row, each exactly once
    assert (plan.buckets - 1) * size < m_out <= plan.buckets * size
    assert 1 < plan.buckets <= ops.SPMM_MAX_BUCKETS or m_out * k * 4 <= (
        ops.SPMM_L2_SHARE)
    # a bucket's slice of the output fits the L2 share, unless the bucket
    # count had to be capped
    assert (size * k * 4 <= ops.SPMM_L2_SHARE or size == 1
            or -(-m_out // (size // 2)) > ops.SPMM_MAX_BUCKETS)
    assert plan.scratch_bytes == nnz * (4 + 4 + itemsize)
    assert plan.per_warp % 32 == 0
    assert plan.blocks == ops.SPMM_BUCKET_BLOCKS_PER_SM * H100_SMS


def test_spmm_plan_at_the_sparse_path_full_shape():
    plan = ops.plan_spmm(WEBBASE_NNZ, SPARSE_DIM, 50, 4, H100_SMS)
    assert (plan.buckets, plan.shift) == (256, 16)       # 2^16 × 200 B
    assert (1 << plan.shift) * 50 * 4 == 13_107_200
    assert plan.scratch_bytes == WEBBASE_NNZ * 12        # ≈ 1.74 GB
    one = ops.plan_spmm(WEBBASE_NNZ, SPARSE_DIM, 50, 4, H100_SMS,
                        row_major=True)
    assert one.buckets == 1


@pytest.mark.parametrize("k,itemsize,ptr,width", [
    (50, 4, 0x7f0000000000, 2), (51, 4, 0x7f0000000000, 1),
    (50, 4, 0x7f0000000004, 1), (50, 2, 0x7f0000000002, 1),
    (50, 2, 0x7f0000000004, 2), (1, 4, 0x7f0000000000, 1)])
def test_vector_width_needs_even_k_and_aligned_rows(k, itemsize, ptr, width):
    assert ops.vector_width(ptr, k, itemsize) == width


def _bucket_scatter(vals, rows, cols, B, m_out, shift, blocks):
    """spmm's L2-blocked scatter in plain torch: per-block histograms of
    row >> shift over contiguous chunks (``blocks`` of them; out-of-range
    rows dropped), the exclusive scan bucket-major then by block, the
    stable copy into
    scratch, and one index_add_ per bucket (columns out of range skipped
    there, as the kernel's scatter pass does)."""
    nnz = vals.numel()
    nb = -(-m_out // (1 << shift))
    chunk = -(-max(nnz, 1) // blocks // 32) * 32
    rows64, cols64 = rows.long(), cols.long()
    ok = (rows64 >= 0) & (rows64 < m_out)
    bucket = torch.where(ok, rows64 >> shift, torch.full_like(rows64, -1))
    block = torch.arange(nnz) // chunk
    counts = torch.zeros((nb, blocks), dtype=torch.int64)
    counts.index_put_((bucket[ok], block[ok]), torch.ones(int(ok.sum()),
                      dtype=torch.int64), accumulate=True)
    offsets = (torch.cumsum(counts.reshape(-1), 0)
               - counts.reshape(-1)).reshape(nb, blocks)
    # rank of each triplet among the earlier ones of its block and bucket
    key = torch.where(ok, bucket * blocks + block, torch.full_like(bucket, -1))
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    first = torch.searchsorted(sorted_key, sorted_key)
    rank = torch.empty(nnz, dtype=torch.int64)
    rank[order] = torch.arange(nnz) - first
    pos = offsets[bucket.clamp_min(0), block] + rank
    total = int(counts.sum())
    s_rows = torch.empty(total, dtype=torch.int64)
    s_cols = torch.empty(total, dtype=torch.int64)
    s_vals = torch.empty(total, dtype=vals.dtype)
    s_rows[pos[ok]], s_cols[pos[ok]], s_vals[pos[ok]] = (
        rows64[ok], cols64[ok], vals[ok])
    # grouped by bucket, and stable: within a bucket in input order
    assert torch.all(s_rows[1:] >> shift >= s_rows[:-1] >> shift)
    out = torch.zeros((m_out, B.shape[1]), dtype=torch.float32)
    n = B.shape[0]
    starts = torch.cumsum(counts.sum(1), 0) - counts.sum(1)
    for b in range(nb):
        lo, hi = int(starts[b]), int(starts[b] + counts[b].sum())
        c = s_cols[lo:hi]
        keep = (c >= 0) & (c < n)
        out.index_add_(0, s_rows[lo:hi][keep],
                       s_vals[lo:hi][keep].float()[:, None]
                       * B.float()[c[keep]])
    return out


@pytest.mark.parametrize("order", ["random", "row-major", "column-major",
                                   "hot row"])
@pytest.mark.parametrize("shift,blocks", [(0, 1), (4, 3), (6, 16), (20, 5)])
def test_bucket_scatter_model_equals_plain_spmm(order, shift, blocks):
    rng = np.random.default_rng(41)
    m, n, k, nnz = 300, 200, 7, 3_000
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    if order == "hot row":
        rows[:] = 17
    elif order == "row-major":
        idx = np.lexsort((cols, rows))
        rows, cols = rows[idx], cols[idx]
    elif order == "column-major":
        idx = np.lexsort((rows, cols))
        rows, cols = rows[idx], cols[idx]
    vals = rng.uniform(size=nnz).astype(np.float32)
    # out-of-range triplets mixed in: rows and columns outside A
    bad = rng.choice(nnz, 40, replace=False)
    rows_b, cols_b = rows.copy(), cols.copy()
    rows_b[bad[:20]] = rng.choice([-1, m, m + 5], 20)
    cols_b[bad[20:]] = rng.choice([-2, n, n + 9], 20)
    B = torch.from_numpy(rng.uniform(size=(n, k)).astype(np.float32))
    t = [torch.from_numpy(x) for x in (vals, rows_b.astype(np.int32),
                                       cols_b.astype(np.int32))]
    got = _bucket_scatter(*t, B, m, shift, blocks)
    keep = torch.from_numpy((rows_b >= 0) & (rows_b < m) & (cols_b >= 0)
                            & (cols_b < n))
    want = ref.spmm(t[0][keep], t[1][keep], t[2][keep], B, m)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# BlockCOO.row_major: the order A·B's plan may rely on
# ---------------------------------------------------------------------------

def _dense_sparse(seed=5, m=12, n=10):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(m, n)).astype(np.float32)
    return a * (rng.uniform(size=(m, n)) < 0.4)


def _source(kind):
    a = _dense_sparse()
    t = torch.from_numpy(a)
    if kind == "numpy":
        return a
    if kind == "dense":
        return t
    if kind == "csr":
        return t.to_sparse_csr()
    if kind == "coalesced":
        return t.to_sparse_coo()
    idx = t.to_sparse_coo()._indices().flip(1)          # column-last first
    vals = t[idx[0], idx[1]]
    return torch.sparse_coo_tensor(idx, vals, t.shape)  # not coalesced


@pytest.mark.parametrize("kind,row_major", [
    ("numpy", True), ("dense", True), ("csr", True), ("coalesced", True),
    ("uncoalesced", False)])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 1)])
def test_blockify_records_row_order_only_where_it_holds(kind, row_major,
                                                        grid):
    from repro_torch.core import blocksparse
    blk = blocksparse.blockify(_source(kind), *grid)
    assert blk.row_major is row_major
    assert torch.equal(blk.todense(), torch.from_numpy(_dense_sparse()))
    if row_major:     # each block's real triplets come in row order
        for i in range(grid[0]):
            for j in range(grid[1]):
                live = blk.vals[i, j] != 0
                r = blk.rows[i, j][live]
                assert bool((r[1:] >= r[:-1]).all())


def test_row_sort_makes_a_blockcoo_row_major_and_spmm_hears_of_it(
        monkeypatch):
    from repro_torch.core import blocksparse
    blk = blocksparse.blockify(_source("uncoalesced"), 1, 1)
    assert not blk.row_major and not blk.to("cpu").row_major
    assert not blk.sort_rows(align=8, orient="cols").row_major
    assert blk.sort_rows(align=8, orient="rows").row_major
    assert blk.sort_rows(align=8).row_major
    seen = []

    def spy(*args, row_major=False, **kw):
        seen.append(row_major)
        return ref.spmm(*args)
    monkeypatch.setattr(ops, "spmm", spy)
    B = torch.from_numpy(np.random.default_rng(1).uniform(
        size=(10, 3)).astype(np.float32))
    for b in (blk, blocksparse.blockify(_source("csr"), 1, 1),
              blk.sort_rows(align=8, orient="rows")):
        got = blocksparse.local_spmm(b, B, impl="cuda")
        torch.testing.assert_close(got, b.todense() @ B)
    assert seen == [False, True, True]
