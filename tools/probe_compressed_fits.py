#!/usr/bin/env python3
"""What int8 panel compression does to a fit, in the JAX package and in the
port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/probe_compressed_fits.py \
        [--parts spread parity bias] [--m 8192] [--n 13824]

  spread  the JAX package's own ``dense`` and ``pallas`` backends, both
          compressed, from the same start (tests/test_torch_compression_
          parity.py's 96 × 64, k = 6 problem, faun 1×1): their scaled W
          and H distance and rel-error gap after 1 and 3 iterations for
          mu, hals and bpp, beside the same for exact fits;
  parity  tests/test_torch_compression_parity.py's runs (JAX on 4 forced
          host devices, the port on gloo ranks) and every gap it holds:
          the largest per rule, step by step and over the whole fit;
  bias    faun 1×1 at ``--m`` × ``--n``, k = 50 (low rank + 0.5·U, as
          chip_smoke.py's Video matrix): for mu and hals (3 iterations)
          and bpp (1), exact and int8, in both packages, the rel error the
          fit reports (from byproducts) beside a direct ||A − WH|| / ||A||
          in float64, and the non-finite entries of W and H.

CPU readings: numerics and counts, no times.  The JAX parts run in fresh
interpreters (``--part-jax``), so this process never imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _lowrank(m: int, n: int, k: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(m, k)).astype(np.float32)
            @ rng.uniform(size=(k, n)).astype(np.float32)
            + 0.5 * rng.uniform(size=(m, n)).astype(np.float32))


def _direct(A, W, H) -> float:
    import numpy as np
    W, H = np.asarray(W, np.float64), np.asarray(H, np.float64)
    num = den = 0.0
    for r0 in range(0, A.shape[0], 4096):
        blk = A[r0:r0 + 4096].astype(np.float64)
        num += float(((blk - W[r0:r0 + 4096] @ H) ** 2).sum())
        den += float((blk ** 2).sum())
    return (num / den) ** 0.5


def _scaled(a, b) -> float:
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_spread() -> dict:
    import jax.numpy as jnp
    import test_torch_compression_parity as P
    from repro.core import faun
    from repro.core.engine import NMFSolver
    A, W0, H0 = (jnp.asarray(x) for x in P._problem())
    grid = faun.make_faun_mesh(1, 1)
    out = {}
    for algo in ("mu", "hals", "bpp"):
        for iters in (1, 3):
            row = {}
            for comp in (None, "int8"):
                fits = [NMFSolver(P.K, algo=algo, schedule="faun", grid=grid,
                                  backend=b, max_iters=iters,
                                  panel_compression=comp).fit(
                            A, W0=W0, H0=H0) for b in ("dense", "pallas")]
                row[str(comp)] = {
                    "W": _scaled(fits[0].W, fits[1].W),
                    "H": _scaled(fits[0].H, fits[1].H),
                    "rel": float(abs(fits[0].rel_errors[-1]
                                     - fits[1].rel_errors[-1]))}
            out[f"{algo}/{iters}"] = row
    return out


def jax_bias(m: int, n: int) -> dict:
    import jax.numpy as jnp
    import numpy as np
    from repro.core import faun
    from repro.core.engine import NMFSolver
    A = _lowrank(m, n, 50)
    grid = faun.make_faun_mesh(1, 1)
    out = {}
    for algo, iters in (("mu", 3), ("hals", 3), ("bpp", 1)):
        for comp in (None, "int8"):
            r = NMFSolver(50, algo=algo, schedule="faun", grid=grid,
                          max_iters=iters, panel_compression=comp).fit(
                              jnp.asarray(A))
            W, H = np.asarray(r.W), np.asarray(r.H)
            out[f"{algo}/{comp}"] = {
                "reported": np.asarray(r.rel_errors).tolist(),
                "direct": _direct(A, W, H),
                "nonfinite": int((~np.isfinite(W)).sum()
                                 + (~np.isfinite(H)).sum())}
    return out


def port_bias(m: int, n: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    A = _lowrank(m, n, 50)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        grid = make_faun_grid(1, 1)
        out = {}
        for algo, iters in (("mu", 3), ("hals", 3), ("bpp", 1)):
            for comp in (None, "int8"):
                r = NMFSolver(50, algo=algo, schedule="faun", grid=grid,
                              device="cpu", max_iters=iters,
                              panel_compression=comp).fit(A)
                W, H = r.W.numpy(), r.H.numpy()
                out[f"{algo}/{comp}"] = {
                    "reported": r.rel_errors.tolist(),
                    "direct": _direct(A, W, H),
                    "nonfinite": int((~np.isfinite(W)).sum()
                                     + (~np.isfinite(H)).sum())}
        return out
    finally:
        dist.destroy_process_group()


def parity() -> dict:
    import test_torch_compression_parity as P
    from repro_torch.util import dist as rdist
    with tempfile.TemporaryDirectory(prefix="probe_parity_") as out:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        subprocess.run([sys.executable, P.__file__, out], env=env,
                       check=True, capture_output=True)
        for p in (1, 2, 4):
            rdist.spawn(P._rank, p, out, p, backend="gloo", device="cpu")
        worst = {}
        for tag, jtag, _ in P.CASES:
            algo = P.RUN[jtag][2]
            g = P.gaps(out, tag, jtag)
            row = worst.setdefault(algo, {"step_W": 0.0, "step_H": 0.0,
                                          "step_rel": 0.0,
                                          "gram_res_steps": 0.0,
                                          "panel_res_steps": 0.0,
                                          "panel_res_flips": 0,
                                          "panel_res_moved": 0,
                                          "fit_W": 0.0, "fit_H": 0.0,
                                          "fit_rel": 0.0, "first_rel": 0.0})
            for _, w, h, rel, steps, panel, flips, moved in g["step"]:
                row["step_W"] = max(row["step_W"], w)
                row["step_H"] = max(row["step_H"], h)
                row["step_rel"] = max(row["step_rel"], rel)
                row["gram_res_steps"] = max(row["gram_res_steps"], steps)
                row["panel_res_steps"] = max(row["panel_res_steps"], panel)
                row["panel_res_flips"] = max(row["panel_res_flips"], flips)
                row["panel_res_moved"] = max(row["panel_res_moved"], moved)
            w, h, rels, first = g["fit"]
            row["fit_W"] = max(row["fit_W"], w)
            row["fit_H"] = max(row["fit_H"], h)
            row["fit_rel"] = max(row["fit_rel"], rels)
            row["first_rel"] = max(row["first_rel"], first)
        return worst


def _in_jax(part: str, *args) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--part-jax", part, *map(str, args)], env=env,
                         check=True, capture_output=True, text=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", nargs="+", default=["spread", "parity", "bias"],
                    choices=["spread", "parity", "bias"])
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--n", type=int, default=13_824)
    ap.add_argument("--part-jax", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.part_jax:
        part, rest = args.part_jax[0], [int(x) for x in args.part_jax[1:]]
        print(json.dumps(jax_spread() if part == "spread"
                         else jax_bias(*rest)))
        return 0
    result = {}
    if "spread" in args.parts:
        result["jax_dense_vs_pallas"] = _in_jax("spread")
    if "parity" in args.parts:
        result["port_vs_jax"] = parity()
    if "bias" in args.parts:
        result["bias"] = {"shape": [args.m, args.n, 50],
                          "jax": _in_jax("bias", args.m, args.n),
                          "port": port_bias(args.m, args.n)}
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
