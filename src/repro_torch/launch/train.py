"""Training launcher.  Counterpart of ``repro/launch/train.py``.

  python -m repro_torch.launch.train --arch smollm-135m \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir ck --device cpu

Runs on ``cuda`` unless ``--device cpu``, with a mesh too (NCCL ranks on
cards, or gloo ranks on the CPU).  ``--mesh none`` is one device;
``--mesh test`` lays a ("data", "model") mesh over the ranks of the
``torch.distributed`` world (under ``torchrun``, which the launcher joins
through ``util.dist.init_from_env``, or inside ``util.dist.spawn``) and
trains sharded (``train.steps``); ``--mesh single`` / ``multipod`` need a
world of 256 / 512 ranks.  Supports restart (auto-restores the latest
checkpoint) and straggler logging.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import base as cb
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_lm_loader
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import steps as steps_lib
from repro_torch.train.loop import LoopConfig, train
from repro_torch.util.device import resolve_device


def _join_world(device):
    """The rank's device on ``--device`` (cuda unless the caller asks for
    the CPU; raises without a card), joining the ``torchrun`` world over
    the backend that device needs if it is not joined yet, and refusing a
    world joined over another backend."""
    from repro_torch.util import dist as rdist
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError("--mesh other than none needs a process "
                               "group: run under torchrun or "
                               "util.dist.spawn")
        return rdist.init_from_env("cuda" if device is None else str(device))
    if dist.get_backend() != backend:
        raise RuntimeError(f"--device {dev.type} trains over {backend}; the "
                           f"process group was joined over "
                           f"{dist.get_backend()}")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--task", default="copy")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "test", "single", "multipod"],
                    default="none")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; under a mesh, each "
                         "rank's own device")
    ap.add_argument("--log-level", default="INFO")
    args = ap.parse_args(argv)

    logging.basicConfig(level=args.log_level,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = (cb.get_reduced_config(args.arch) if args.reduced
           else cb.get_config(args.arch))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = OptConfig(kind=cfg.optimizer, lr=args.lr,
                        warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)

    if args.mesh == "none":
        mesh = None
        dev = resolve_device(args.device)
    else:
        dev = _join_world(args.device)
        mesh = (make_test_mesh() if args.mesh == "test"
                else make_production_mesh(multi_pod=args.mesh == "multipod"))

    rt = steps_lib.make_runtime(mesh)
    state = steps_lib.init_train_state(cfg, opt_cfg, args.seed, device=dev)
    # restart path: restore if a checkpoint exists
    restored, rstep = ckpt_lib.restore(args.ckpt_dir, state)
    if restored is not None:
        print(f"resuming from step {rstep}")
        state = restored
    if mesh is not None:
        state = steps_lib.shard_state(state, mesh)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, rt=rt)

    batch_fn = make_lm_loader(cfg, shape, seed=args.seed, task=args.task,
                              device=dev)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir)
    state, history = train(state, step_fn, batch_fn, loop_cfg)
    if history:
        print(f"done: {len(history)} steps, "
              f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return history


if __name__ == "__main__":
    main()
