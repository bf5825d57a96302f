"""The port's ``faun`` on four gloo ranks against the JAX package's ``faun``
on four forced host devices: the same grid, the same numpy A and explicit
W0/H0, so W's row order (pr, pc) and H's column order (pc, pr) must come
out the same.  Also the multi-pod grid (JAX's ("pod", "pr") rows against
the port's ``pods=2``) and bf16 panel gathers (``panel_dtype``).

The JAX side runs this file as a script in a fresh interpreter, which
forces 4 host devices before JAX is imported; the port's ranks are spawned
once for the module (``util.dist.spawn``).  Neither imports JAX here at
the top.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.backends import SparseOps
from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
ITERS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (tag, algo, JAX backend, port backend, grid kind)
#   grid kind: "2x2", "pods" (JAX pod×pr×pc = 2×2×1, port pods=2, 2×1),
#   "bf16" (2×2 with panel_dtype=bf16)
CASES = ([(f"{a}_{b}", a, "dense", b, "2x2")
          for a in ("mu", "hals", "bpp", "amu", "ahals")
          for b in ("cuda", "dense")]
         + [(f"{a}_sparse_{impl}", a, "sparse", impl, "2x2")
            for a in ("mu", "hals", "bpp") for impl in ("scatter", "sorted")]
         + [(f"{a}_pods", a, "dense", "cuda", "pods")
            for a in ("mu", "hals", "bpp")]
         + [(f"{a}_bf16_{b}", a, "dense", b, "bf16")
            for a in ("mu", "hals") for b in ("cuda", "dense")])
TOL = {"2x2": 1e-4, "pods": 1e-4, "bf16": 2e-2}


def _problem(seed=0, m=M, n=N, k=K, noise=0.5):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + noise * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0


def _rank(out):
    """Every case on this rank's cell; rank 0 writes the results."""
    A, W0, H0 = _problem()
    grids = {"2x2": make_faun_grid(2, 2),
             "pods": make_faun_grid(2, 1, pods=2)}
    for tag, algo, _, backend, kind in CASES:
        ops = (SparseOps(spmm_impl=backend)
               if backend in ("scatter", "sorted") else backend)
        res = NMFSolver(
            K, algo=algo, schedule="faun", backend=ops, device="cpu",
            grid=grids["pods" if kind == "pods" else "2x2"],
            panel_dtype=torch.bfloat16 if kind == "bf16" else None,
            max_iters=ITERS).fit(A, W0=W0, H0=H0)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out, f"port_{tag}.npz"), W=res.W.numpy(),
                     H=res.H.numpy(), rels=res.rel_errors.numpy())


def _jax_main(out):
    """JAX's faun on 4 forced host devices (run as a script)."""
    from repro.util import env
    env.configure(host_device_count=4)        # before any jax import
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import faun
    from repro.core.engine import NMFSolver as JaxSolver
    devs = np.asarray(jax.devices()[:4])
    grids = {"2x2": faun.make_faun_mesh(2, 2),
             "pods": faun.FaunGrid(mesh=Mesh(devs.reshape(2, 2, 1),
                                             ("pod", "pr", "pc")),
                                   row_axes=("pod", "pr"), col_axis="pc")}
    A, W0, H0 = (jnp.asarray(x) for x in _problem())
    for tag, algo, backend, _, kind in CASES:
        res = JaxSolver(K, algo=algo, schedule="faun", backend=backend,
                        grid=grids["pods" if kind == "pods" else "2x2"],
                        panel_dtype=jnp.bfloat16 if kind == "bf16" else None,
                        max_iters=ITERS).fit(A, W0=W0, H0=H0)
        np.savez(os.path.join(out, f"jax_{tag}.npz"), W=np.asarray(res.W),
                 H=np.asarray(res.H), rels=np.asarray(res.rel_errors))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("faun_layout"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jax_run = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                out], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        rdist.spawn(_rank, 4, out, backend="gloo", device="cpu")
    finally:
        log, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, log
    return out


def _load(out, name):
    with np.load(os.path.join(out, f"{name}.npz")) as z:
        return {key: z[key] for key in z.files}


def _assert_scaled(got, want, atol):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_faun_matches_jax_faun(runs, case):
    tag, kind = case[0], case[4]
    got, want = _load(runs, f"port_{tag}"), _load(runs, f"jax_{tag}")
    assert got["W"].shape == want["W"].shape == (M, K)
    assert got["H"].shape == want["H"].shape == (K, N)
    np.testing.assert_allclose(got["rels"], want["rels"], rtol=TOL[kind])
    _assert_scaled(got["W"], want["W"], TOL[kind])
    _assert_scaled(got["H"], want["H"], TOL[kind])


if __name__ == "__main__":
    _jax_main(sys.argv[1])
