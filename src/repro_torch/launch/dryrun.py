"""Multi-pod dry run: run one step of every (architecture × input shape ×
mesh) cell on fake tensors in a fake world of 256 or 512 ranks, count what
rank 0 dispatches, and persist one JSON per cell for the roofline report.
Counterpart of ``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --nmf   # paper cells

The reference lowers and compiles each step to XLA HLO over 512 forced
host devices and parses the module.  Eager PyTorch has no such program;
here the step runs once, as rank 0 of a ``torch.distributed`` world of the
``fake`` backend (no process but this one, nothing sent), on tensors of a
``FakeTensorMode`` (no data: the state of a 72B model costs nothing), and
``roofline.counts.record_step`` counts its aten ops, matmul FLOPs, bytes,
kernel calls and collectives.  The fake tensors stand for the card: they
live on ``cuda`` where PyTorch has a usable CUDA runtime, else on
``meta`` (``util.device.resolve_device``).  No card is needed.

A cell runs ``make_train_step`` (train shapes), ``make_prefill_step``
(prefill) or ``make_serve_step`` (decode, its caches split as
``steps.local_caches`` says: the batch over the data dims, the KV length
over "model", a split recurrent layer's state over its channels or heads)
on the production mesh (16×16 "data" × "model", or 2×16×16 with "pod"),
through ``make_runtime(mesh)``: tensor-parallel over "model" as the
reference's GSPMD program is (FFN columns, vocabulary and RG-LRU channels
split where they divide, attention and xLSTM cells on each rank's whole
heads, unevenly where they do not: rank 0 holds ⌈H/tp⌉, the bound's
rank; ``sharding.compute_spec``), without sequence
parallelism, as the reference's ``lower_cell`` runs.  A layer stack costs
Python time per op here, not per byte, so a cell runs its architecture at
g = 2 and 3 layer groups (``depth_variant``) and extrapolates to the
full G: cost(2) + (G − 2)·(cost(3) − cost(2)) for FLOPs, bytes,
collectives, the inputs' bytes and the peak (an architecture of three
groups or fewer runs at full depth).  Eager PyTorch runs every group as
the same ops, so this is exact (``tests/test_torch_dryrun_serve.py``
holds it against a full-depth run).  The first group is off the line for
the peak: while it runs, no earlier layer's output is alive yet (a
tensor-parallel prefill of qwen2-72b: 1.80, 1.93, 1.94, 1.94 GB at g = 1–4
and 4,096 tokens, so g = 1 and 2 would add 0.14 GB a group where the
caches add 2 MB); the reference's g = 0 is off it for the counts (a model
without layer groups skips a few small ops over the stacked leaves).  A
step that
raises is recorded as ``fail``; the pass criterion is every cell ``ok``.

Importing this module has no side effect: ``main`` makes the fake world,
and refuses to where a default process group of another backend exists.
Records go to ``build/dryrun/``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import base as cb
from repro_torch.roofline import counts
from repro_torch.roofline.hw import H100, roofline_times

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "build", "dryrun")
#: ranks of one pod of the multi-pod mesh: collectives whose group spans
#: pods cross InfiniBand (``roofline.hw``)
POD_RANKS = 256


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """Make the default process group a ``fake`` world of ``n`` ranks, this
    process rank 0 (an existing fake world of another size is replaced).
    Refuses where a default group of another backend exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"the dry run makes its own fake world; this process "
                f"already has a {backend} default group (run the dry run "
                f"in a process of its own)")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(mesh_kind: str):
    from repro_torch.launch.mesh import make_production_mesh
    multi = mesh_kind == "multipod"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def depth_variant(cfg, g: int):
    """Same architecture with g layer groups (+ the unchanged tail)."""
    period = len(cfg.layer_pattern)
    tail = cfg.n_layers % period
    kw = {"n_layers": period * g + tail}
    if cfg.is_encdec:
        enc_period = len(cfg.encoder_pattern)
        kw["encoder_layers"] = enc_period * g
    return cfg.replace(**kw)


def n_groups_of(cfg) -> int:
    return cfg.n_layers // len(cfg.layer_pattern)


def _fake_like(tree, dev):
    """Fake tensors of a tree of ``meta`` tensors' shapes and dtypes on
    ``dev`` (made inside the fake mode: ``meta`` tensors do not mix with
    fake ones on another device)."""
    if isinstance(tree, dict):
        return {k: _fake_like(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_like(v, dev) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    return tree


def lower_cell(arch: str, shape_name: str, mesh, *, opt_override=None,
               cfg=None, shape=None):
    """Build the right step function for one cell and run it once on fake
    tensors: (``StepRecord``, cfg, shape).  The record's ``arg_bytes`` are
    the rank's state (parameters, optimizer, caches) and batch.  ``cfg``
    and ``shape`` (a ``ShapeConfig``) stand in for the named ones."""
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps as steps_lib
    from repro_torch.util.convert import stack_params
    from repro_torch.util.device import resolve_device
    cfg = cfg or cb.get_config(arch)
    shape = shape or cb.SHAPES[shape_name]
    rt = steps_lib.make_runtime(mesh)
    with counts.stand_in_card(), counts.fake_mode():
        dev = resolve_device(None)
        specs = _fake_like(lm.input_specs(cfg, shape), dev)
        if shape.kind == "train":
            opt_cfg = OptConfig(kind=opt_override or cfg.optimizer)
            state = steps_lib.shard_state(
                steps_lib.init_train_state(cfg, opt_cfg, 0, device=dev),
                mesh)
            step = steps_lib.make_train_step(cfg, opt_cfg, rt=rt)
            args = (state, specs)
        else:
            params = steps_lib.shard_params(
                stack_params(lm.LM(cfg, device=dev, seed=0).tree()), mesh)
            if shape.kind == "prefill":
                step = steps_lib.make_prefill_step(cfg, kv_len=shape.seq_len,
                                                   rt=rt)
                args = (params, specs)
            else:
                step = steps_lib.make_serve_step(cfg, rt=rt)
                caches = steps_lib.local_caches(specs["caches"], mesh,
                                                shape.global_batch)
                args = (params, caches, specs["tokens"], shape.seq_len - 1)
        arg_bytes = counts.tensor_bytes(args)
        with counts.record_step() as rec:
            step(*args)
        rec.arg_bytes = arg_bytes
    return rec, cfg, shape


def _costs(rec: counts.StepRecord, pod_size) -> dict:
    """The extrapolated quantities of one record."""
    st = counts.collective_stats(rec)
    ici, dcn = rec.wire_bytes(pod_size)
    return {"flops_by_rate": dict(rec.flops_by_rate),
            "bytes": rec.bytes, "ici": ici, "dcn": dcn,
            "counts": dict(st.counts), "wire": dict(st.wire_bytes),
            "kernels": dict(rec.kernel_calls()),
            "arg_bytes": rec.arg_bytes, "peak_bytes": rec.peak_bytes}


#: the depth variants a cell of more than three groups runs at
DEPTHS = (2, 3)


def _extrapolate(c2: dict, c3: dict, G: int) -> dict:
    """cost(2) + (G − 2)·(cost(3) − cost(2)), each quantity."""
    def lin(a, b):
        if isinstance(a, dict) or isinstance(b, dict):
            return {k: lin(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
        return a + (G - DEPTHS[0]) * (b - a)
    return {k: lin(c2[k], c3[k]) for k in c2}


def cell_costs(arch: str, shape_name: str, mesh, *, cfg=None, shape=None,
               full_depth: bool = False, pod_size=None) -> dict:
    """The cell's per-rank costs: from the depth variants (module
    docstring), or from one run at full depth."""
    cfg = cfg or cb.get_config(arch)
    G = n_groups_of(cfg)
    if full_depth or G <= 3:
        rec, _, _ = lower_cell(arch, shape_name, mesh, cfg=cfg, shape=shape)
        return _costs(rec, pod_size)
    var = [_costs(lower_cell(arch, shape_name, mesh, shape=shape,
                             cfg=depth_variant(cfg, g))[0], pod_size)
           for g in DEPTHS]
    return _extrapolate(*var, G)


def _record(rec: dict, c: dict, n_chips: int) -> dict:
    """The reference's record keys from the costs ``c``."""
    arg, peak = c["arg_bytes"], c["peak_bytes"]
    roof = roofline_times(c["flops_by_rate"], c["bytes"], c["ici"],
                          chip=H100, dcn_bytes=c["dcn"])
    rec.update({
        "status": "ok",
        "n_chips": n_chips,
        "memory": {"argument_bytes": arg, "temp_bytes": peak,
                   "peak_bytes": arg + peak},
        "flops_per_chip": sum(c["flops_by_rate"].values()),
        "flops_by_rate": c["flops_by_rate"],
        "bytes_accessed_per_chip": c["bytes"],
        "collectives": c["counts"],
        "collective_bytes_per_chip": c["ici"] + c["dcn"],
        "collective_dcn_bytes_per_chip": c["dcn"],
        "collective_wire_by_op": c["wire"],
        "kernels": c["kernels"],
        "roofline": roof,
        "counted": True,
    })
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             save: bool = True, verbose: bool = True, cfg=None, shape=None,
             mesh=None) -> dict:
    """One cell's record (the reference's keys, plus ``kernels``);
    ``cfg``, ``shape`` and ``mesh`` (a ``DeviceMesh``) stand in for the
    named ones and the production mesh."""
    cfg = cfg or cb.get_config(arch)
    shape = shape or cb.SHAPES[shape_name]
    ok, reason = cb.cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "skip", "reason": reason}
    if not ok:
        if verbose:
            print(f"SKIP {arch} × {shape_name} [{mesh_kind}]: {reason}")
        if save:
            _save(rec)
        return rec
    t0 = time.time()
    try:
        mesh = mesh or production_mesh(mesh_kind)
        pods = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("pod", 1)
        c = cell_costs(arch, shape_name, mesh, cfg=cfg, shape=shape,
                       pod_size=mesh.size() // pods if pods > 1 else None)
        _record(rec, c, mesh.size())
        rec.update({"n_groups": n_groups_of(cfg),
                    "lower_s": time.time() - t0})
        if verbose:
            mem = rec["memory"]
            print(f"OK   {arch} × {shape_name} [{mesh_kind}] "
                  f"run={rec['lower_s']:.1f}s "
                  f"flops/chip={rec['flops_per_chip']:.3e} "
                  f"hbm={rec['bytes_accessed_per_chip'] / 1e9:.2f}GB "
                  f"coll={rec['collective_bytes_per_chip'] / 1e6:.1f}MB "
                  f"peak={mem['peak_bytes'] / 1e9:.2f}GB "
                  f"dom={rec['roofline']['dominant']} "
                  f"wire_bytes={rec['collective_bytes_per_chip']!r} "
                  f"peak_bytes={mem['peak_bytes']!r}", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"FAIL {arch} × {shape_name} [{mesh_kind}]: "
                  f"{type(e).__name__}: {e}", flush=True)
    if save:
        _save(rec)
    return rec


#: The paper's own workloads on the production grids: (name, m, n, k,
#: algo, multipod), sizes adjusted to the nearest grid-divisible value, as
#: the paper does (§6.1.1)
NMF_CELLS = (
    ("nmf_video_dense", 1_013_760, 13_824, 50, "mu", False),
    ("nmf_video_dense", 1_013_760, 13_824, 50, "mu", True),
    ("nmf_synth_dense", 207_360, 138_240, 50, "bpp", False),
    ("nmf_synth_dense", 207_360, 138_240, 50, "bpp", True),
    ("nmf_webbase_like", 1_048_576, 1_048_576, 50, "hals", False),
)


def nmf_cell(grid, m: int, n: int, k: int, algo: str, *,
             backend="dense", pod_size=None) -> dict:
    """One FAUN iteration on ``grid`` counted (``faun.lower_step``), with
    the cost model's words beside it."""
    from repro_torch.core.engine import NMFSolver
    with counts.stand_in_card():
        solver = NMFSolver(k, algo=algo, schedule="faun", backend=backend,
                           grid=grid)
        rec = solver.lower_step(m, n)
        words = solver.predict_cost(m, n).words
    c = _costs(rec, pod_size)
    c["costmodel_wire_bytes"] = 4.0 * (words + error_words(k, grid.p))
    return c


def error_words(k: int, p: int) -> float:
    """fp32 words a rank receives for the error from byproducts: one k × k
    Gram all-reduce and one scalar all-reduce over the p ranks, which the
    cost model's ``words`` leave out (``costmodel.schedule_cost_terms``
    prices that Gram as its informational "error" term)."""
    return 2.0 * (p - 1) / p * (k * k + 1)


def run_nmf_cells(*, save: bool = True, cells=NMF_CELLS,
                  verbose: bool = True) -> list[dict]:
    from repro_torch.launch.mesh import make_faun_production_grid
    out = []
    for name, m, n, k, algo, mp in cells:
        mesh_kind = "multipod" if mp else "single"
        rec = {"arch": name, "shape": f"m{m}_n{n}_k{k}_{algo}",
               "mesh": mesh_kind, "status": "fail"}
        t0 = time.time()
        try:
            fake_world(512 if mp else 256)
            grid = make_faun_production_grid(multi_pod=mp)
            c = nmf_cell(grid, m, n, k, algo,
                         pod_size=POD_RANKS if mp else None)
            _record(rec, c, grid.p)
            rec.update({"lower_s": time.time() - t0,
                        "grid": [grid.pr, grid.pc],
                        "costmodel_wire_bytes": c["costmodel_wire_bytes"]})
            if verbose:
                print(f"OK   {name} k={k} {algo} [{mesh_kind}] "
                      f"run={rec['lower_s']:.1f}s "
                      f"flops/chip={rec['flops_per_chip']:.3e} "
                      f"coll={rec['collective_bytes_per_chip'] / 1e6:.3f}MB "
                      f"(model {c['costmodel_wire_bytes'] / 1e6:.3f}MB) "
                      f"dom={rec['roofline']['dominant']} "
                      f"wire_bytes={rec['collective_bytes_per_chip']!r} "
                      f"costmodel_bytes={c['costmodel_wire_bytes']!r} "
                      f"peak_bytes={rec['memory']['peak_bytes']!r}",
                      flush=True)
        except Exception as e:  # noqa: BLE001
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            if verbose:
                print(f"FAIL {name} [{mesh_kind}]: {e}", flush=True)
        if save:
            _save(rec)
        out.append(rec)
    return out


def _save(rec: dict):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    fn = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json".replace("/", "_")
    with open(os.path.join(RESULTS_DIR, fn), "w") as f:
        json.dump(rec, f, indent=1)


@contextlib.contextmanager
def _own_world():
    """The fake world this run makes, destroyed at the end."""
    made = not dist.is_initialized()
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (see configs); default = all")
    ap.add_argument("--shape", default=None,
                    help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--mesh", default=None, choices=["single", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--nmf", action="store_true",
                    help="run the paper's NMF dry-run cells")
    ap.add_argument("--no-save", action="store_true")
    args = ap.parse_args(argv)
    if dist.is_initialized() and dist.get_backend() != "fake":
        raise SystemExit(f"the dry run makes its own fake world; this "
                         f"process already has a {dist.get_backend()} "
                         f"default group")

    with _own_world():
        if args.nmf:
            recs = run_nmf_cells(save=not args.no_save)
            n_fail = sum(r["status"] != "ok" for r in recs)
            print(f"\nNMF dry run complete; {n_fail} failures")
            sys.exit(1 if n_fail else 0)

        archs = [args.arch] if args.arch else cb.ARCH_IDS
        shapes = [args.shape] if args.shape else list(cb.SHAPES)
        meshes = [args.mesh] if args.mesh else ["single", "multipod"]

        n_fail = 0
        for arch in archs:
            for shape in shapes:
                for mk in meshes:
                    rec = run_cell(arch, shape, mk, save=not args.no_save)
                    n_fail += rec["status"] == "fail"
        print(f"\ndry-run complete; {n_fail} failures")
        sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
