#!/usr/bin/env python3
"""Each gradient leaf of xlstm-125m split over "model" by uneven whole
heads against the unsharded gradient, in fp32 and in bf16, on the CPU.

    PYTHONPATH=src python tools/probe_uneven_grads.py [--ranks 3]

Three gloo ranks on the CPU run ``steps.sharded_grads`` of xlstm-125m at
full width (d = 768, 4 heads: 2 / 1 / 1 on (1, 3)), cut to its first
four layers (one mLSTM period and the sLSTM) and a vocabulary of 256, on
a 2 × 64 batch, in bf16 and in fp32 (the bf16 weights upcast: the fp32
twin); rank 0 prints, for the input- and forget-gate biases and every
leaf whose bf16 distance exceeds 1.5 × its twin's, the leaf's relative L2
distance from the unsharded gradient, and in bf16 that distance over the
unsharded bf16 leaf's own distance from its fp32 twin (chip_smoke.py
phase 38's leaf rule, whose worst it prints over the leaves within
``NOISE_LEAF`` = 0.5 of their twins), then the whole gradients'.
"""

import argparse
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _rel(a, b) -> float:
    den = float(b.float().norm())
    num = float((a.float() - b.float()).norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}".lstrip("/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}".lstrip("/"))
    elif tree is not None:
        yield path, tree


def _rank(tp: int) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import base as cb
    from repro_torch.models.lm import LM
    from repro_torch.train import steps as st
    from repro_torch.util.convert import stack_params
    torch.set_num_threads(2)
    mesh = init_device_mesh("cpu", (1, tp), mesh_dim_names=("data", "model"))
    bf16 = cb.get_config("xlstm_125m").replace(n_layers=4, vocab=256,
                                               mlstm_chunk=32)
    fp32 = bf16.replace(param_dtype="float32", dtype="float32")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 256, (2, 64), generator=g),
             "labels": torch.randint(0, 256, (2, 64), generator=g)}
    p16 = stack_params(LM(bf16, device="cpu", seed=0).tree())
    p32 = torch.utils._pytree.tree_map(lambda t: t.float(), p16)
    out = {}
    for tag, cfg, params in (("fp32", fp32, p32), ("bf16", bf16, p16)):
        _, _, ref = st.grads_of(cfg, params, [batch])
        _, _, got = st.sharded_grads(cfg, st.shard_params(params, mesh),
                                     batch, st.make_runtime(mesh))
        out[tag] = dict(_leaves(ref)), dict(_leaves(st.full_state(
            st.wrap_shards(got, params, mesh))))
    if dist.get_rank():
        return
    twin = {p: _rel(r, out["fp32"][0][p]) for p, r in out["bf16"][0].items()}
    for tag, (ref, got) in out.items():
        dists = {p: _rel(got[p], r) for p, r in ref.items()}
        for p, d in dists.items():
            if tag == "fp32" and p.endswith(("cell/bi", "cell/bf")):
                print(f"fp32 {p}: {d:.3e} from the unsharded")
            elif tag == "bf16" and (p.endswith(("cell/bi", "cell/bf"))
                                    or d > 1.5 * twin[p]):
                print(f"bf16 {p}: {d:.3e} from the unsharded, "
                      f"{d / twin[p]:.2f} x its twin's {twin[p]:.3e}")
        if tag == "bf16":
            held = [p for p in twin if 0 < twin[p] < 0.5]
            print(f"bf16 worst ratio over the {len(held)} of {len(twin)} "
                  f"leaves within 0.5 of their twins: " + str(max(
                      (dists[p] / twin[p], p) for p in held)))
        num = sum(float((got[p].float() - r.float()).norm()) ** 2
                  for p, r in ref.items())
        den = sum(float(r.float().norm()) ** 2 for r in ref.values())
        print(f"{tag} whole gradient {math.sqrt(num / den):.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=3)
    args = ap.parse_args()
    from repro_torch.util import dist as rdist
    rdist.spawn(_rank, args.ranks, args.ranks, backend="gloo", device="cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
