"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_ep``)
against the JAX package's ``moe_ep`` under ``shard_map``.

The JAX side runs on 4 forced host devices in a fresh interpreter (this
file runs itself as a script: JAX fixes its device count at first use),
the port on 4 gloo ranks, both on a 2 × 2 ("data", "model") mesh, from the
same numpy parameters and input.  For reduced dbrx (4 experts, top 2) and
reduced llama4 (8 experts, top 1, the shared expert split over "model"),
on both paths (tokens sharded over "model" with per-shard capacity and two
all-to-alls; decode-sized input with a sum over "model"): the output and
the router loss, and the gradients of L = mean over data shards of
Σ y·w, plus the router loss, with respect to every parameter and the
input.  Tolerance: max |Δ| / max |ref| ≤ 1e-5 (outputs), 1e-4
(gradients) or, for a leaf the reference's own fp32 gradient holds less
closely, twice its distance from the float64 gradient: top-1 routing
(llama4) normalises each token's one weight to 1, so the router's
gradient is the router loss's alone (≈ 1e-3 at most) plus fp32
cancellation of the zero gradient through w / Σw, and both packages sit
≈ 2e-3 (scaled) from float64 there.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("dbrx_132b", "llama4_maverick")
PATHS = {"a2a": (4, 16), "psum": (2, 1)}      # (B, S): T % mp = 0 or not
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _cfg_kw(arch):
    """Capacity generous enough that no token drops on either path."""
    return {"capacity_factor": 4.0}


def _inputs(arch, d_model, path):
    rng = np.random.default_rng(11)
    B, S = PATHS[path]
    x = rng.standard_normal((B, S, d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, d_model)).astype(np.float32)
    return x, w


def _params(arch):
    """The moe params of the JAX init, as numpy (the same file both sides
    read)."""
    import jax
    from repro.configs import base as jcb
    from repro.models import moe as jmoe
    cfg = jcb.get_reduced_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **_cfg_kw(arch)))
    return cfg, jax.tree.map(np.asarray,
                             jmoe.init_moe(jax.random.PRNGKey(4), cfg))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_main(out):
    from repro.util import env
    env.configure(host_device_count=4)        # before any jax import
    import jax
    jax.config.update("jax_enable_x64", True)   # the float64 gradients
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro.util.compat import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {}
    for arch in ARCHS:
        cfg, p = _params(arch)
        for k, v in _flat(p).items():
            res[f"{arch}/param/{k}"] = v
        for path in PATHS:
            x, w = _inputs(arch, cfg.d_model, path)

            def loss(p, x, w=w):
                y, aux = jmoe.moe_ep(p, x, cfg, mesh, data_axes=("data",),
                                     model_axis="model")
                return (y * w).sum() / 2 + aux, (y, aux)

            grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True))
            (val, (y, aux)), (gp, gx) = grad(
                jax.tree.map(jnp.asarray, p), jnp.asarray(x))
            res[f"{arch}/{path}/y"] = np.asarray(y)
            res[f"{arch}/{path}/aux"] = np.asarray(aux)
            res[f"{arch}/{path}/gx"] = np.asarray(gx)
            for k, v in _flat(gp).items():
                res[f"{arch}/{path}/g/{k}"] = v
            _, (gp64, _) = grad(
                jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), p),
                jnp.asarray(x, jnp.float64))
            for k, v in _flat(gp64).items():
                res[f"{arch}/{path}/g64/{k}"] = v
    np.savez(os.path.join(out, "jax.npz"), **res)


def _port_rank(out, ref_path):
    """One gloo rank: the port's moe_ep on this rank's data shard; the
    parameter gradients averaged over the data ranks (the train step's
    reduction), the input gradient of this shard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import base as cb
    from repro_torch.models import moe
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d = mesh.get_local_rank("data")
    dgroup = mesh.get_group("data")
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    res = {}
    for arch in ARCHS:
        cfg = cb.get_reduced_config(arch)
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **_cfg_kw(arch)))
        flat = {k.split("/param/")[1]: v for k, v in ref.items()
                if k.startswith(f"{arch}/param/")}
        for path in PATHS:
            p = {}
            for k, v in flat.items():
                parts = k.split(".")
                tgt = p
                for q in parts[:-1]:
                    tgt = tgt.setdefault(q, {})
                tgt[parts[-1]] = torch.tensor(v, requires_grad=True)
            x, w = _inputs(arch, cfg.d_model, path)
            rows = x.shape[0] // 2
            xl = torch.tensor(x[d * rows:(d + 1) * rows], requires_grad=True)
            wl = torch.tensor(w[d * rows:(d + 1) * rows])
            y, aux = moe.moe_ep(p, xl, cfg, mesh, data_axes=("data",))
            ((y * wl).sum() + aux).backward()
            res[f"{arch}/{path}/y"] = y.detach().numpy()
            res[f"{arch}/{path}/aux"] = float(aux)
            # the global loss is the mean over the data shards
            res[f"{arch}/{path}/gx"] = xl.grad.numpy() / 2
            leaves = {}

            def walk(t, prefix=""):
                for k, v in t.items():
                    if isinstance(v, dict):
                        walk(v, f"{prefix}{k}.")
                    else:
                        g = v.grad.clone()
                        dist.all_reduce(g, group=dgroup)
                        leaves[f"{prefix}{k}"] = (g / 2).numpy()
            walk(p)
            for k, v in leaves.items():
                res[f"{arch}/{path}/g/{k}"] = v
    res["rank"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    torch.save(res, os.path.join(out, f"rank{dist.get_rank()}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.util import dist as rdist
    out = str(tmp_path_factory.mktemp("moe_ep"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    ref_path = os.path.join(out, "jax.npz")
    rdist.spawn(_port_rank, 4, out, ref_path, backend="gloo", device="cpu")
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    return ref, ranks


def scaled(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_output_and_router_loss_match_jax(runs, arch, path):
    ref, ranks = runs
    for res in ranks:
        d, _ = res["rank"]
        y_ref = ref[f"{arch}/{path}/y"]
        rows = y_ref.shape[0] // 2
        assert scaled(res[f"{arch}/{path}/y"],
                      y_ref[d * rows:(d + 1) * rows]) <= OUT_TOL
        aux = float(ref[f"{arch}/{path}/aux"])
        assert abs(res[f"{arch}/{path}/aux"] - aux) <= OUT_TOL * abs(aux)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(runs, arch, path):
    ref, ranks = runs
    names = [k.split("/g/")[1] for k in ref if k.startswith(
        f"{arch}/{path}/g/")]
    tol = {n: max(GRAD_TOL, 2 * scaled(ref[f"{arch}/{path}/g/{n}"],
                                       ref[f"{arch}/{path}/g64/{n}"]))
           for n in names}
    assert names
    for res in ranks:
        d, _ = res["rank"]
        gx = ref[f"{arch}/{path}/gx"]
        rows = gx.shape[0] // 2
        assert scaled(res[f"{arch}/{path}/gx"],
                      gx[d * rows:(d + 1) * rows]) <= GRAD_TOL
        for name in names:
            key = f"{arch}/{path}/g/{name}"
            err = scaled(res[key], ref[key])
            assert err <= tol[name], (key, err, tol[name])


if __name__ == "__main__":
    _jax_main(sys.argv[1])
