"""The plans and the numerics of the port's redesigned kernels (gram,
ts_matmul, ts_matmul_t, spmm, spmm_sorted, mu_update, hals_sweep), without
a GPU.

The kernels (``kernels/csrc/gram.cu``, ``kernels/csrc/ts_matmul.cu``) take
their grids from plans computed in Python (``kernels/ops.py``): a persistent
grid of row slabs for gram, and a split contraction for ts_matmul when its
output cannot fill the card.  ts_matmul multiplies fp32 on the tensor cores
as three TF32 products (3xTF32).  Here the plans are checked for coverage
and size, and a numpy model of the 3xTF32 split is held against float64 and
against the JAX package's plain ``ts_matmul`` on the parity inputs.
mu_update's plan covers every k (tiles, ring stages, G whole or in column
chunks, or the row-per-warp kernel); torch models of mu_update's and
spmm_sorted's walks write each output once and match the plain versions.
hals_sweep's plan fits every k from 1 to 1,000 or names the row-per-warp
kernel, and a torch model of its column-blocked sweep matches the plain
version and the JAX package's Pallas kernel (interpret mode).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import blocksparse  # noqa: E402
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


# ---------------------------------------------------------------------------
# mu_update's plan (any k) and a model of its tile walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 50, 128, 129, 256, 1_000])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("r", [1, 4_099, 1_013_400, 1 << 24])
def test_mu_plan_fits_shared_memory_for_every_k(k, itemsize, r):
    plan = ops.plan_mu_update(r, k, itemsize, H100_SMS)
    assert plan.rows > 0 and plan.rows % plan.rt == 0
    assert plan.rt in (1, 2, 4, 8) and 1 <= plan.stages <= 3
    assert plan.smem == ops.mu_smem(k, plan.rows, plan.stages, plan.chunk,
                                    itemsize, 4, plan.direct)
    assert plan.smem <= ops.SMEM_PER_BLOCK
    per_sm = -(-plan.blocks // H100_SMS)
    assert per_sm * (plan.smem + ops.SMEM_RESERVED_PER_BLOCK) \
        <= ops.SMEM_PER_SM
    assert 1 <= plan.blocks <= -(-r // plan.rows)
    # G whole, or in chunks of a multiple of 4 columns
    assert plan.chunk == k or (plan.chunk % 4 == 0 and 4 <= plan.chunk < k)
    # read where it lands only in fp32, where 16 rows fall in 16 banks
    assert plan.direct == (itemsize == 4 and np.gcd(k, 32) <= 2)
    if plan.direct:
        banks = {(i * k) % 32 for i in range(ops.MU_ROW_SLICES)}
        assert len(banks) == ops.MU_ROW_SLICES


def test_mu_plan_at_the_main_paths():
    for r in (1_013_400, 1 << 24):
        plan = ops.plan_mu_update(r, 50, 4, H100_SMS)
        # 128-row tiles, two stages, two blocks per SM, G whole, x in place
        assert plan[:5] == (128, 2, 50, 8, 2 * H100_SMS) and plan.direct
        bf16 = ops.plan_mu_update(r, 50, 2, H100_SMS)
        assert bf16[:5] == (128, 2, 50, 8, 2 * H100_SMS)
        assert not bf16.direct


@pytest.mark.parametrize("k,itemsize", [(2_100, 4), (5_000, 2),
                                        (100_000, 4)])
def test_mu_plan_takes_the_row_per_warp_kernel_past_shared_memory(k,
                                                                  itemsize):
    plan = ops.plan_mu_update(1_000, k, itemsize, H100_SMS)
    assert plan.rows == 0 and plan.smem == 0
    assert plan.blocks == min(-(-1_000 // 8),
                              ops.LUC_ROWWISE_BLOCKS_PER_SM * H100_SMS)


def _mu_walk(X, G, R, eps, plan):
    """mu_update_kernel's walk in torch: block b takes tiles b, b + blocks,
    ... of plan.rows rows; per tile, G in column chunks; each (X·G)_j one
    fp32 chain over l in order.  Also counts the writes of each output."""
    r, k = X.shape
    out = torch.full_like(X, float("nan"))
    writes = torch.zeros(r, k, dtype=torch.int32)
    ntiles = -(-r // plan.rows)
    for b in range(plan.blocks):
        for t in range(b, ntiles, plan.blocks):
            rows = slice(t * plan.rows, min(r, (t + 1) * plan.rows))
            x, rr = X[rows].float(), R[rows].float()
            for c0 in range(0, k, plan.chunk):
                cols = slice(c0, min(k, c0 + plan.chunk))
                acc = torch.zeros(x.shape[0], cols.stop - c0)
                for l in range(k):
                    acc = torch.addcmul(acc, x[:, l:l + 1], G[l:l + 1, cols])
                out[rows, cols] = (x[:, cols] * (rr[:, cols] / (acc + eps))
                                   ).to(X.dtype)
                writes[rows, cols] += 1
    return out, writes


@pytest.mark.parametrize("r,k", [(301, 50), (37, 129), (64, 7), (5, 1_000)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_mu_walk_covers_each_output_once_and_matches_the_plain_version(
        r, k, itemsize):
    rng = np.random.default_rng(40)
    dt = torch.float32 if itemsize == 4 else torch.bfloat16
    X = torch.from_numpy(rng.uniform(size=(r, k)).astype(np.float32)).to(dt)
    C = torch.from_numpy(rng.uniform(size=(30, k)).astype(np.float32))
    R = torch.from_numpy(rng.uniform(size=(r, k)).astype(np.float32) * 5)
    G = C.T @ C
    plan = ops.plan_mu_update(r, k, itemsize, H100_SMS)
    plan = plan._replace(blocks=min(plan.blocks, 3))   # several tiles a block
    got, writes = _mu_walk(X, G, R, 1e-16, plan)
    assert (writes == 1).all()
    want = ref.mu_update(X, G, R)
    scale = want.float().abs().max()
    tol = 1e-5 if itemsize == 4 else 2e-2
    np.testing.assert_allclose((got.float() / scale).numpy(),
                               (want.float() / scale).numpy(), atol=tol)


# ---------------------------------------------------------------------------
# spmm_sorted's row-run walk over the packed layout
# ---------------------------------------------------------------------------

def _sorted_walk(blk, B):
    """spmm_sorted_kernel's walk in torch: per 8-row tile its units in
    packed order, a running row sum stored when the row changes and zeros
    for the tile's rows without triplets; counts each row's stores."""
    m = blk.block_shape[0]
    k = B.shape[1]
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    valid, first = blk.row_valid.reshape(-1), blk.row_first.reshape(-1)
    out = torch.full((m, k), float("nan"))
    stores = torch.zeros(m, dtype=torch.int32)

    def store(row, val):
        out[row] = val
        stores[row] += 1
    for t in range(-(-m // 8)):
        row0, row_end = 8 * t, min(8 * t + 8, m)
        cur, nxt, acc = -1, row0, None
        for u in range(int(first[t]), int(first[t + 1])):
            for s in range(int(valid[u])):
                i = u * blk.align + s
                row = int(r[i])
                if row != cur:
                    if cur >= 0:
                        store(cur, acc)
                        nxt = cur + 1
                    while nxt < row:
                        store(nxt, torch.zeros(k))
                        nxt += 1
                    cur, acc = row, torch.zeros(k)
                acc = acc + v[i].float() * B[int(c[i])].float()
        if cur >= 0:
            store(cur, acc)
            nxt = cur + 1
        while nxt < row_end:
            store(nxt, torch.zeros(k))
            nxt += 1
    return out, stores


@pytest.mark.parametrize("m,n,density", [(43, 30, 0.2), (16, 9, 0.0),
                                         (61, 200, 0.05)])
def test_sorted_walk_stores_each_row_once_and_matches_the_plain_version(
        m, n, density):
    rng = np.random.default_rng(41)
    A = rng.uniform(size=(m, n)) * (rng.uniform(size=(m, n)) < density)
    if m > 20:
        A[3] = rng.uniform(size=n)                 # a hot row: many units
        A[9:17] = 0.0                              # an empty tile
    A = torch.from_numpy(A.astype(np.float32))
    blk = blocksparse.blockify(A, 1, 1).sort_rows(align=8)
    B = torch.from_numpy(rng.uniform(size=(n, 5)).astype(np.float32))
    got, stores = _sorted_walk(blk, B)
    assert (stores == 1).all()
    torch.testing.assert_close(got, A @ B, rtol=0, atol=1e-5)



# ---------------------------------------------------------------------------
# hals_sweep's plan (any k) and a model of its column-blocked sweep
# ---------------------------------------------------------------------------

def _smallest_hals_tile(k, itemsize, r_itemsize):
    """Shared memory of the smallest tile hals_sweep_kernel takes: one warp,
    a row each, one stage, one column block of G."""
    direct = itemsize == 4 and np.gcd(k, 32) <= 2
    return ops.hals_smem(k, 32, 1, 1, itemsize, r_itemsize, direct)


@pytest.mark.parametrize("itemsize,r_itemsize", [(4, 4), (2, 4), (2, 2)])
@pytest.mark.parametrize("r", [1, 4_099, 1_013_400])
def test_hals_plan_fits_shared_memory_for_every_k(itemsize, r_itemsize, r):
    fallback = []
    for k in range(1, 1_001):
        plan = ops.plan_hals_sweep(r, k, itemsize, H100_SMS,
                                   r_itemsize=r_itemsize)
        if plan.rows == 0:
            # only where not even the smallest tile fits
            assert (_smallest_hals_tile(k, itemsize, r_itemsize)
                    > ops.SMEM_PER_BLOCK), k
            assert plan.blocks == min(-(-r // 8), ops.LUC_ROWWISE_BLOCKS_PER_SM
                                      * H100_SMS)
            fallback.append(k)
            continue
        assert plan.rows in ops.HALS_ROWS and plan.stages in ops.HALS_STAGES
        assert plan.tpr in (1, ops.HALS_WIDE_TPR)
        threads = plan.rows * plan.tpr
        assert threads <= ops.HALS_MAX_THREADS
        nb = -(-k // ops.HALS_BLOCK)
        assert plan.gblocks in (1, nb)
        assert plan.direct == (itemsize == 4 and np.gcd(k, 32) <= 2)
        assert plan.smem == ops.hals_smem(k, plan.rows, plan.stages,
                                          plan.gblocks, itemsize, r_itemsize,
                                          plan.direct)
        assert plan.smem <= ops.SMEM_PER_BLOCK
        per_sm = -(-plan.blocks // H100_SMS)
        assert per_sm * (plan.smem + ops.SMEM_RESERVED_PER_BLOCK) \
            <= ops.SMEM_PER_SM
        assert per_sm * threads <= ops.HALS_THREADS_PER_SM
        # the persistent grid covers every tile once: no more blocks than
        # tiles, and the tiles of rows cover r
        ntiles = -(-r // plan.rows)
        assert 1 <= plan.blocks <= ntiles
        assert (ntiles - 1) * plan.rows < r <= ntiles * plan.rows
        assert plan.rows <= max(32, -(-r // 32) * 32)    # no idle warps
        # threads share a row only where a row a thread leaves the SM few
        if plan.tpr > 1:
            assert (ops._hals_blocks_per_sm(plan.smem, plan.rows) * plan.rows
                    < ops.HALS_MIN_THREADS_PER_SM), k
    # every k up to 256 runs the column-blocked kernel
    assert not fallback or min(fallback) > 256


def test_hals_plan_at_the_main_paths():
    for r in (1_013_400, 1 << 24):
        plan = ops.plan_hals_sweep(r, 50, 4, H100_SMS)
        # 256-row tiles, a thread a row, one stage, G whole, two blocks an
        # SM, x swept in place
        assert plan[:5] == (256, 1, 4, 1, 2 * H100_SMS) and plan.direct
    # k = 160: G whole leaves room for 64 rows; four threads a row keep
    # eight warps on the SM
    wide = ops.plan_hals_sweep(1_013_400, 160, 4, H100_SMS)
    assert wide[:4] == (64, 1, 10, 4) and not wide.direct


def _hals_walk(X, G, R, eps, plan):
    """hals_sweep_kernel's walk in torch: block b takes tiles b, b + blocks,
    ... of plan.rows rows; per tile the sweep in column blocks of
    HALS_BLOCK (the last rounded up to 4).  Each column c's sum: the
    columns outside the block as they stand, one fp32 chain in order;
    the block's old columns from c on; then, as the block's columns are
    swept in order, each new value (rounded to X's dtype) times its row of
    G added to the later columns' sums; x ← max(0, x + (r − s)·(1 /
    max(G_jj, ε))).  Also counts the writes of each output."""
    r, k = X.shape
    hb = ops.HALS_BLOCK
    out = torch.full_like(X, float("nan"))
    writes = torch.zeros(r, k, dtype=torch.int32)
    Gp = torch.zeros(k, -(-k // hb) * hb)
    Gp[:, :k] = G
    rd = 1.0 / G.diagonal().clamp_min(eps)
    ntiles = -(-r // plan.rows)
    for b in range(plan.blocks):
        for t in range(b, ntiles, plan.blocks):
            rows = slice(t * plan.rows, min(r, (t + 1) * plan.rows))
            x, rr = X[rows].float().clone(), R[rows].float()
            for j0 in range(0, k, hb):
                w = min(hb, -(-(k - j0) // 4) * 4)
                jw = min(k, j0 + w)
                gb = Gp[:, j0:j0 + w]
                p = torch.zeros(x.shape[0], w)
                for l in [*range(j0), *range(jw, k)]:
                    p = torch.addcmul(p, x[:, l:l + 1], gb[l:l + 1])
                for e in range(jw - j0):             # old, from c on
                    p[:, :e + 1] = torch.addcmul(p[:, :e + 1],
                                                 x[:, j0 + e:j0 + e + 1],
                                                 gb[j0 + e:j0 + e + 1, :e + 1])
                for c in range(jw - j0):
                    j = j0 + c
                    v = torch.addcmul(x[:, j], rr[:, j] - p[:, c], rd[j])
                    x[:, j] = torch.clamp_min(v, 0.0).to(X.dtype).float()
                    p[:, c + 1:] = torch.addcmul(p[:, c + 1:], x[:, j:j + 1],
                                                 gb[j:j + 1, c + 1:])
            out[rows] = x.to(X.dtype)
            writes[rows] += 1
    return out, writes


@pytest.mark.parametrize("k", [1, 7, 16, 50, 129, 160])
@pytest.mark.parametrize("r", [37, 301])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hals_walk_covers_each_output_once_and_matches_plain_and_jax(
        k, r, dt):
    """The blocked sweep against the plain version: fp32 within 1e-5 on the
    sweep's scale, bf16 within 2e-2 column by column (a new column rounds
    to bf16 before later columns read it in both); and against the Pallas
    kernel (interpret mode), which
    takes one dtype for all operands and keeps the sweep in fp32: in bf16
    G is rounded to bf16 for both and they agree at 2e-2 of the output's
    maximum, as test_torch_luc.py holds the plain version."""
    rng = np.random.default_rng(42)
    xdt = torch.float32 if dt == "f32" else torch.bfloat16
    X = torch.from_numpy(rng.uniform(size=(r, k)).astype(np.float32)).to(xdt)
    X[r // 2] = 0.0
    C = rng.uniform(size=(30, k)).astype(np.float32)
    if k > 2:
        C[:, 2] = 0.0                             # G_22 = 0: the ε guard
    G = torch.from_numpy(C.T @ C)
    if dt == "bf16":
        G = G.bfloat16().float()
    R = torch.from_numpy(rng.uniform(size=(r, k)).astype(np.float32) * 5)
    R = R.to(xdt)
    eps = ref.LUC_EPS
    plan = ops.plan_hals_sweep(r, k, X.element_size(), H100_SMS,
                               r_itemsize=R.element_size())
    assert plan.rows > 0
    # tiles of one warp, walked by two blocks: several tiles a block and a
    # ragged last tile
    plan = plan._replace(rows=32, blocks=2)
    got, writes = _hals_walk(X, G, R, eps, plan)
    assert (writes == 1).all() and got.dtype == xdt
    tol = 1e-5 if dt == "f32" else 2e-2
    want = ref.hals_sweep(X, G, R, eps)
    if dt == "f32":
        assert ref.sweep_scaled_err(got, want, X, G, R, eps) <= tol
    else:
        diff = (got.float() - want.float()).abs().amax(0)
        assert (diff <= tol * want.float().abs().amax(0)).all()
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    jx = jops.hals_sweep(jnp.asarray(X.float().numpy(), jdt),
                         jnp.asarray(G.numpy(), jdt),
                         jnp.asarray(R.float().numpy(), jdt))
    jx = torch.from_numpy(np.array(jx, np.float32))
    if dt == "f32":
        assert ref.sweep_scaled_err(got, jx, X, G, R, eps) <= tol
    else:
        scale = jx.abs().max()
        torch.testing.assert_close(got.float() / scale, jx / scale,
                                   rtol=0, atol=tol)
