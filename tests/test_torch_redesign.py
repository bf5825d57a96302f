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

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from repro_torch.kernels import ops

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
