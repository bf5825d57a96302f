"""The port's kernel wrappers (repro_torch.kernels.ops) against the JAX
package's Pallas wrappers (interpret mode on the CPU) and its oracles, over
test_kernels.py's shapes, in fp32 and bf16.

On the CPU each port wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against those versions on the card by
test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops

torch.set_num_threads(1)

# The shapes of tests/test_kernels.py.
SHAPES = [(64, 48, 8), (96, 128, 16), (100, 70, 10), (128, 64, 50),
          (32, 256, 4)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}   # scaled atol, as in test_kernels.py


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


def _both(x, dt):
    """The same values as a torch tensor and a jax array of dtype ``dt``
    (both round fp32 to bf16 to nearest-even)."""
    tdt, jdt = DTYPES[dt]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _assert_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.float32        # every kernel returns fp32
    return t.numpy()


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_gram_matches_jax(m, n, k, dt):
    (x,) = _inputs(1, (m, k))
    X, Xj = _both(x, dt)
    got = _np(ops.gram(X))
    _assert_close(got, jops.gram(Xj), TOL[dt])
    _assert_close(got, jref.gram(Xj), TOL[dt])


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_ts_matmul_matches_jax(m, n, k, dt):
    a, b = _inputs(2, (m, n), (n, k))
    (A, Aj), (B, Bj) = _both(a, dt), _both(b, dt)
    got = _np(ops.ts_matmul(A, B))
    _assert_close(got, jops.ts_matmul(Aj, Bj), TOL[dt])
    _assert_close(got, jref.ts_matmul(Aj, Bj), TOL[dt])


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_ts_matmul_t_matches_jax(m, n, k, dt):
    a, b = _inputs(3, (m, n), (m, k))
    (A, Aj), (B, Bj) = _both(a, dt), _both(b, dt)
    got = _np(ops.ts_matmul_t(A, B))
    _assert_close(got, jops.ts_matmul_t(Aj, Bj), TOL[dt])
    _assert_close(got, jref.ts_matmul_t(Aj, Bj), TOL[dt])


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    a, b = _inputs(4, (40, 30), (30, 5))
    ops.ts_matmul(torch.from_numpy(a), torch.from_numpy(b))
    ops.ts_matmul_t(torch.from_numpy(a), torch.from_numpy(a[:, :5].copy()))
    ops.gram(torch.from_numpy(b))
    idx = torch.arange(8, dtype=torch.int32)
    vals, B = torch.ones(8), torch.from_numpy(b)
    ops.spmm(vals, idx, idx, B, 40)
    ops.spmm_sorted(vals, idx, idx, torch.zeros(1, dtype=torch.int32),
                    torch.full((1,), 8, dtype=torch.int32), B, 8, align=8)
    assert ops.LAUNCHES == {"gram": 0, "ts_matmul": 0, "ts_matmul_t": 0,
                            "spmm": 0, "spmm_sorted": 0}


@pytest.mark.parametrize("case", ["strided", "dtype_mix", "f16", "shape",
                                  "empty", "rank3", "not_a_tensor"])
def test_wrappers_reject_what_kernels_do_not_take(case):
    a, b = _inputs(5, (16, 12), (12, 4))
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises((ValueError, TypeError)):
        if case == "strided":
            ops.ts_matmul(A.T, torch.zeros(16, 4))       # the H.T view
        elif case == "dtype_mix":
            ops.ts_matmul(A, B.to(torch.bfloat16))
        elif case == "f16":
            ops.gram(B.half())
        elif case == "shape":
            ops.ts_matmul_t(A, B)
        elif case == "empty":
            ops.gram(torch.zeros((0, 4)))
        elif case == "rank3":
            ops.gram(torch.zeros((2, 3, 4)))
        else:
            ops.ts_matmul(a, B)


@pytest.mark.parametrize("depth,tiles,sms", [(1_013_400, 108, 132),
                                             (1_013_400, 1, 132),
                                             (13_824, 1, 132), (50, 1, 132),
                                             (4099, 3, 132), (1, 1, 1)])
@pytest.mark.parametrize("per_sm", [8, 32])
def test_plan_slabs_covers_depth(depth, tiles, sms, per_sm):
    slab, slabs = ops.plan_slabs(depth, tiles, sms, step=32, min_slab=128,
                                 blocks_per_sm=per_sm)
    assert slab % 32 == 0 and 1 <= slabs <= 65535
    assert (slabs - 1) * slab < depth <= slabs * slab
    assert slabs == 1 or slab >= 128


_FAKE_NVCC = """#!/bin/sh
out=''
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then out=$2; fi
  shift
done
echo "ptxas info    : Used 40 registers"
"""


@pytest.mark.parametrize("ok", [True, False])
def test_build_runs_one_nvcc_per_source(tmp_path, monkeypatch, ok):
    """build() with a stand-in nvcc: a library per source, the compiler's
    log kept beside it, nothing rebuilt on a second call; a failed compile
    raises with the log and leaves no library."""
    fake = tmp_path / "nvcc"
    fake.write_text(_FAKE_NVCC + ('touch "$out"\n' if ok
                                  else 'echo "error: boom"; exit 2\n'))
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    if ok:
        paths = build.build()
        assert sorted(paths) == sorted(build.SOURCES)
        assert all(p.exists() for p in paths.values())
        assert "registers" in build.build_log("gram")
        stamp = {p: p.stat().st_mtime_ns for p in paths.values()}
        assert build.build() == paths
        assert {p: p.stat().st_mtime_ns for p in paths.values()} == stamp
    else:
        with pytest.raises(RuntimeError, match="boom"):
            build.build()
        assert not list((tmp_path / "build").glob("*.so"))


def test_build_targets_hopper_and_hashes_sources(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    for name in build.SOURCES:
        src = build.CSRC / f"{name}.cu"
        assert src.exists()
        cmd = build.nvcc_command(name, build.library_path(name))
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert build.library_path(name).name.startswith(f"{name}-")
        assert set(build.SIGNATURES[name]) <= set(
            s.split("(")[0].split()[-1] for s in src.read_text().splitlines()
            if s.startswith('extern "C" int'))

