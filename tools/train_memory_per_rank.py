#!/usr/bin/env python3
"""What one rank holds at the peaks of the port's sharded train step, per
full-size architecture, on the production meshes (16 × 16 and
2 × 16 × 16), counted from the parameter shapes and the sharding rules
(nothing allocated: the state lives on the ``meta`` device).

    python3 tools/train_memory_per_rank.py [--arch smollm_135m ...]

Columns (GB, 1e9 bytes, per rank; activations are not counted):

* ``state``: the rank's shards of the parameters and the optimizer state;
* ``once``: the parameters gathered once a step (embeddings, final norms,
  frontends) and the stacks' tail layers (no remat: kept until their
  backward);
* ``group``: the largest layer group's parameters as its layers gather
  them on use;

each gathered over the data dims and, where a rank computes the leaf
split over "model" (``sharding.compute_spec``: heads, FFN columns,
vocabulary rows, E/mp experts), kept at its share of "model";
* ``fwd_bwd``: state + 2 × (once + group) (each with a gradient of its
  size before the reduce-scatter) + the stacks' gradient shards;
* ``update``: state + the gradient shards + the new shards (every
  optimizer updates the shards);
* ``peak``: the larger of the two, against the card's 80 GB.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CARD_GB = 80.0


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _leaves(tree, specs, path=""):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, (v, s) in enumerate(zip(tree, specs)):
            yield from _leaves(v, s, f"{path}/{i}")
    else:
        yield path, tree, specs


def _shard_bytes(t, spec, shape) -> float:
    n = t.numel() * t.element_size()
    for axes in spec:
        for a in (() if axes is None else
                  (axes,) if isinstance(axes, str) else axes):
            n /= shape[a]
    return n


def per_rank(arch: str, mesh_shape: dict) -> dict:
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    cfg = cb.get_config(arch)
    opt = OptConfig(kind=cfg.optimizer)
    state = steps.train_state_specs(cfg, opt)
    specs = steps.state_specs(state, FakeMesh(mesh_shape))
    shard = sum(_shard_bytes(t, s, mesh_shape) for part in ("params", "opt")
                for _, t, s in _leaves(state[part], specs[part]))
    grad_shards = sum(_shard_bytes(t, s, mesh_shape) for _, t, s in
                      _leaves(state["params"], specs["params"]))
    once, groups = 0.0, {}
    for path, t, s in _leaves(state["params"], specs["params"]):
        keys = path.strip("/").split("/")
        n = t.numel() * t.element_size()
        if sharding.compute_spec(path, s, cfg, FakeMesh(mesh_shape))[0] \
                is not None:
            n /= mesh_shape["model"]
        if steps._in_stack(keys) and keys[1] == "groups":
            # one group's share of a stacked leaf, summed per stack
            groups[keys[0]] = groups.get(keys[0], 0.0) + n / t.shape[0]
        else:
            once += n
    group = max(groups.values(), default=0.0)
    fwd_bwd = shard + 2 * (once + group) + grad_shards
    update = shard + 2 * grad_shards
    gb = 1e9
    return {"arch": arch, "opt": opt.kind, "state": shard / gb,
            "once": once / gb, "group": group / gb, "fwd_bwd": fwd_bwd / gb,
            "update": update / gb, "peak": max(fwd_bwd, update) / gb}


def main(argv=None) -> int:
    from repro_torch.configs import base as cb
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="*", default=list(cb.ARCH_IDS))
    args = ap.parse_args(argv)
    print(f"{'mesh':8s} {'arch':20s} {'opt':9s} {'state':>8s} {'once':>8s} "
          f"{'group':>8s} {'fwd_bwd':>8s} {'update':>8s} {'peak':>8s}  "
          f"fits {CARD_GB:g} GB")
    for mname, mshape in MESHES.items():
        for arch in args.arch:
            r = per_rank(arch, mshape)
            print(f"{mname:8s} {arch:20s} {r['opt']:9s} {r['state']:8.2f} "
                  f"{r['once']:8.2f} {r['group']:8.2f} {r['fwd_bwd']:8.2f} "
                  f"{r['update']:8.2f} "
                  f"{r['peak']:8.2f}  "
                  f"{'yes' if r['peak'] < CARD_GB else 'NO'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
