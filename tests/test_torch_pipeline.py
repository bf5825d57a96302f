"""``repro_torch.distributed.pipeline``: GPipe over four gloo ranks (the
port's cases of tests/distributed_checks.py's ``pipeline_matches_
sequential`` and ``pipeline_grads_flow``): the forward and the gradients
within 1e-5 of the sequential stack, and of the JAX ``pipeline_apply``
with ``jax.grad`` on 4 forced host devices from the same numpy parameters
(this file run as a script in a fresh interpreter, which forces the
devices before JAX is imported); ``make_pipelined_loss`` too."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.util import dist as rdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, NM, MB, D = 4, 8, 4, 16
TOL = 1e-5


def _problem():
    rng = np.random.default_rng(11)
    W = (rng.normal(size=(S, D, D)) / D ** 0.5).astype(np.float32)
    x = rng.normal(size=(NM, MB, D)).astype(np.float32)
    t = rng.normal(size=(NM, MB, D)).astype(np.float32)
    return W, x, t


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"])


def _rank(out):
    """This rank's stage: y, the gradients of mean(y²) and of the
    pipelined loss for its slice, and the sequential stack's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.distributed.pipeline import (bubble_fraction,
                                                  make_pipelined_loss,
                                                  pipeline_apply)
    W, x, t = _problem()
    mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("pp",))
    r = dist.get_rank()
    # the stage dim sharded over "pp": a DTensor, and its local tensor
    Wd = distribute_tensor(torch.tensor(W), mesh, [Shard(0)])
    Wd.requires_grad_(True)
    y = pipeline_apply(_stage_fn, {"w": Wd}, torch.tensor(x), mesh, "pp")
    (y ** 2).mean().backward()
    # what the forward puts on the wire
    from repro_torch.util.wire import record_wire
    with torch.no_grad(), record_wire() as wire:
        pipeline_apply(_stage_fn, {"w": Wd}, torch.tensor(x), mesh, "pp")
    w_loc = torch.tensor(W[r:r + 1], requires_grad=True)
    loss = make_pipelined_loss(_stage_fn, lambda a, b: ((a - b) ** 2).mean(),
                               mesh)({"w": w_loc}, torch.tensor(x),
                                     torch.tensor(t))
    loss.backward()
    # the sequential stack on one rank
    Wf = torch.tensor(W, requires_grad=True)
    h = torch.tensor(x)
    for s in range(S):
        h = _stage_fn({"w": Wf[s]}, h)
    (h ** 2).mean().backward()
    Wl = torch.tensor(W, requires_grad=True)
    hl = torch.tensor(x)
    for s in range(S):
        hl = _stage_fn({"w": Wl[s]}, hl)
    seq_loss = ((hl - torch.tensor(t)) ** 2).mean(dim=(1, 2)).mean()
    seq_loss.backward()
    np.savez(os.path.join(out, f"port_{r}.npz"), y=y.detach().numpy(),
             g=Wd.grad.to_local().numpy()[0], loss=loss.item(),
             g_loss=w_loc.grad.numpy()[0], y_seq=h.detach().numpy(),
             g_seq=Wf.grad.numpy()[r], loss_seq=seq_loss.item(),
             g_loss_seq=Wl.grad.numpy()[r], bubble=bubble_fraction(S, NM),
             wire_ops=np.array([c.op for c in wire]),
             wire_received=np.array([c.received for c in wire]))


def _jax_main(out):
    """The JAX package's pipeline on 4 forced host devices."""
    from repro.util import env
    env.configure(host_device_count=4)        # before any jax import
    import jax
    import jax.numpy as jnp
    from repro.distributed.pipeline import pipeline_apply
    from repro.util.compat import make_mesh
    W, x, _ = _problem()
    mesh = make_mesh((S,), ("pp",))

    def stage_fn(p, xx):
        return jnp.tanh(xx @ p["w"])

    def loss(sp):
        return jnp.mean(pipeline_apply(stage_fn, sp, jnp.asarray(x), mesh,
                                       "pp") ** 2)

    sp = {"w": jnp.asarray(W)}
    y = pipeline_apply(stage_fn, sp, jnp.asarray(x), mesh, "pp")
    g = jax.grad(loss)(sp)
    np.savez(os.path.join(out, "jax.npz"), y=np.asarray(y),
             g=np.asarray(g["w"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jax_run = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                out], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
    try:
        rdist.spawn(_rank, S, out, backend="gloo", device="cpu")
    finally:
        log, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, log
    ranks = [dict(np.load(os.path.join(out, f"port_{r}.npz")))
             for r in range(S)]
    return ranks, dict(np.load(os.path.join(out, "jax.npz")))


def test_pipeline_matches_sequential(runs):
    ranks, _ = runs
    for got in ranks:        # every stage returns the last stage's outputs
        np.testing.assert_allclose(got["y"], got["y_seq"], atol=TOL)


def test_pipeline_grads_flow(runs):
    ranks, _ = runs
    for got in ranks:
        np.testing.assert_allclose(got["g"], got["g_seq"], atol=TOL)
        assert np.abs(got["g"]).max() > 0


def test_pipelined_loss_and_its_grads(runs):
    ranks, _ = runs
    for got in ranks:
        np.testing.assert_allclose(got["loss"], got["loss_seq"], atol=TOL)
        np.testing.assert_allclose(got["g_loss"], got["g_loss_seq"],
                                   atol=TOL)
    assert ranks[0]["bubble"] == pytest.approx((S - 1) / (NM + S - 1))


def test_forward_wire_is_one_hop_a_tick_and_the_final_sum(runs):
    """Each of the M + S − 2 hops is one all-to-all that receives the
    whole activation, (MB, D) fp32; the outputs' sum is one all-reduce."""
    ranks, _ = runs
    hops = NM + S - 2
    for got in ranks:
        assert list(got["wire_ops"]) == ["all_to_all"] * hops + ["all_reduce"]
        np.testing.assert_array_equal(got["wire_received"][:hops],
                                      [MB * D * 4.0] * hops)


def test_pipeline_matches_jax(runs):
    ranks, want = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["y"], want["y"], atol=TOL)
        np.testing.assert_allclose(got["g"], want["g"][r], atol=TOL)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
