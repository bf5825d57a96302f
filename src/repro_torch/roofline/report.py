"""Roofline report: aggregates the dry run's JSON records
(``launch/dryrun.py``) into the roofline tables (the LM cells and the NMF
cells), adds MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) and the
useful-compute ratio.  Counterpart of ``repro/roofline/report.py``.

  PYTHONPATH=src python -m repro_torch.roofline.report           # print
  PYTHONPATH=src python -m repro_torch.roofline.report --write   # file

Every figure is counted on fake tensors (``roofline/counts.py``), not
measured: FLOPs, bytes and wire bytes per rank of one step, and the three
roofline times against ``roofline.hw.H100``.  "HBM fit" holds the record's
peak (the rank's inputs plus the most the step holds alive at once)
against the H100's 80 GB.  The LM cells run tensor-parallel over "model"
(16 ranks on both production meshes): the "note" column names what a
rank computes whole there instead (``tp_note``: heads or KV heads that do
not divide, a vocabulary that does not, xLSTM cells whose heads do not).  The NMF
table puts the cost model's words
(``core/costmodel.py``) beside the counted wire bytes.  The measured
per-phase protocol is ``NMFSolver.fit(profile=True)`` joined against
``costmodel.schedule_cost_terms`` by ``repro_torch.obs.report``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from repro_torch.configs import base as cb
from repro_torch.roofline.hw import H100

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "build", "dryrun")


def param_counts(cfg) -> tuple[int, int]:
    """(total_params, active_params) excluding embedding/unembedding."""
    from repro_torch.models import lm
    from repro_torch.util.convert import stack_params
    tree = stack_params(lm.init_params(cfg, 0, device=torch.device("meta")))
    total = active = 0

    def walk(t, path):
        nonlocal total, active
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
            return
        if isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
            return
        ps = "/".join(path)
        n = t.numel()
        if "embed" in ps or "unembed" in ps:
            return
        total += n
        if "/moe/w" in ps:          # routed experts: only top_k of E active
            active += n * cfg.moe.top_k / max(cfg.moe.n_experts, 1)
        else:
            active += n

    walk(tree, ())
    return int(total), int(active)


def model_flops(cfg, shape) -> float:
    """Global MODEL_FLOPS for one step of this cell (standard 6ND / 2ND
    conventions; attention not included — the ratio column absorbs it)."""
    _, n_active = param_counts(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch          # decode: one token


def load_cells(mesh: str = "single", results_dir: str = RESULTS_DIR):
    cells = []
    for fn in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("mesh") == mesh:
            cells.append(rec)
    return cells


def hbm_fit(rec: dict) -> str:
    """"YES", or "NO (… GB)": the record's peak against the H100's HBM."""
    peak = rec.get("memory", {}).get("peak_bytes", 0.0)
    return "YES" if peak <= H100.hbm_bytes else f"NO ({peak / 1e9:.0f}GB)"


#: ranks of "model" on the production meshes (``launch.mesh``)
MODEL_RANKS = 16


def tp_note(cfg, tp: int = MODEL_RANKS) -> str:
    """What each rank of "model" computes otherwise than on its 1/tp
    (``distributed.sharding.compute_spec``): attention and xLSTM cells
    whose heads do not divide, on its whole heads, unevenly (at most
    ⌈H/tp⌉ a rank, ``head_range``); the KV projections, vocabulary and
    sLSTM FFN that run whole.  Every other attention, FFN, vocabulary
    and recurrent product runs on the rank's 1/tp (an RG-LRU over its
    channels, an xLSTM cell over whole heads)."""
    uneven, whole = [], []
    kinds = set(cfg.layer_pattern) | (set(cfg.encoder_pattern)
                                      if cfg.is_encdec else set())
    most = f"{cfg.n_heads} over {tp} (≤ {-(-cfg.n_heads // tp)} a rank)"
    if kinds & {"attn", "local_attn", "attn_cross", "enc_attn", "xattn"}:
        if cfg.n_heads % tp:
            uneven.append(f"attention {most}")
        if cfg.n_kv % tp:
            whole.append(f"KV projections ({cfg.n_kv} KV heads)")
    if cfg.vocab % tp:
        whole.append(f"vocabulary ({cfg.vocab})")
    cells = sorted(kinds & {"mlstm", "slstm"})
    if cells and cfg.n_heads % tp:
        uneven.append("/".join(k[0] + k[1:].upper() for k in cells)
                      + f" cells {most}")
    if "slstm" in kinds and ((4 * cfg.d_model) // 3) % tp:
        whole.append("sLSTM FFN")
    return "; ".join(([f"uneven heads: {', '.join(uneven)}"] if uneven
                      else []) + ([f"whole: {', '.join(whole)}"] if whole
                                  else []))


def fmt_table(mesh: str = "single", results_dir: str = RESULTS_DIR) -> str:
    rows = []
    header = ("| arch | shape | status | compute s | memory s | collective s"
              " | dominant | MODEL_GF/chip | counted_GF/chip | useful |"
              " HBM fit | note |")
    sep = "|" + "---|" * 12
    rows.append(header)
    rows.append(sep)
    for rec in load_cells(mesh, results_dir):
        arch, shape_name = rec["arch"], rec["shape"]
        if arch.startswith("nmf_"):
            continue
        if rec["status"] == "skip":
            rows.append(f"| {arch} | {shape_name} | SKIP | — | — | — | — |"
                        f" — | — | — | — | sub-quadratic-only shape |")
            continue
        if rec["status"] != "ok":
            rows.append(f"| {arch} | {shape_name} | FAIL | — | — | — | — |"
                        f" — | — | — | — | {rec.get('error', '')[:60]} |")
            continue
        cfg = cb.get_config(arch)
        shape = cb.SHAPES[shape_name]
        mf = model_flops(cfg, shape) / rec["n_chips"]
        hf = rec["flops_per_chip"]
        roof = rec["roofline"]
        rows.append(
            f"| {arch} | {shape_name} | OK "
            f"| {roof['compute_s']:.4f} | {roof['memory_s']:.4f} "
            f"| {roof['collective_s']:.4f} "
            f"| {roof['dominant'].replace('_s', '')} "
            f"| {mf / 1e9:.1f} | {hf / 1e9:.1f} "
            f"| {min(mf / max(hf, 1e-9), 9.99):.2f} | {hbm_fit(rec)} "
            f"| {tp_note(cfg)} |")
    return "\n".join(rows)


def _nmf_tag(tag: str) -> tuple[int, int, int, str]:
    """(m, n, k, algo) from a record's ``m…_n…_k…_algo`` shape tag."""
    parts = tag.split("_")
    return int(parts[0][1:]), int(parts[1][1:]), int(parts[2][1:]), parts[3]


def nmf_table(results_dir: str = RESULTS_DIR) -> str:
    rows = ["| workload | grid | algo | compute s | memory s | collective s |"
            " dominant | αβγ-model words | counted wire bytes | HBM fit |",
            "|" + "---|" * 10]
    from repro_torch.core import costmodel
    for fn in sorted(glob.glob(os.path.join(results_dir, "nmf_*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['mesh']} | — | — | — | — |"
                        f" FAIL | — | — | — |")
            continue
        roof = rec["roofline"]
        m, n, k, algo = _nmf_tag(rec["shape"])
        pr, pc = rec["grid"]
        model = costmodel.mpifaun_cost(m, n, k, pr, pc, algo=algo)
        rows.append(
            f"| {rec['arch']} ({m}×{n}, k={k}) | {pr}×{pc} | {algo} "
            f"| {roof['compute_s']:.5f} | {roof['memory_s']:.5f} "
            f"| {roof['collective_s']:.5f} "
            f"| {roof['dominant'].replace('_s', '')} "
            f"| {model.words:.3e} | {rec['collective_bytes_per_chip']:.3e} "
            f"| {hbm_fit(rec)} |")
    return "\n".join(rows)


def summary(results_dir: str = RESULTS_DIR):
    cells = [r for r in load_cells("single", results_dir)
             if not r["arch"].startswith("nmf")]
    ok = [r for r in cells if r["status"] == "ok"]
    print(f"cells: {len(cells)} ({len(ok)} ok, "
          f"{sum(r['status'] == 'skip' for r in cells)} skip, "
          f"{sum(r['status'] == 'fail' for r in cells)} fail)")
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    summary()
    t = fmt_table(args.mesh)
    n = nmf_table()
    print(t)
    print()
    print(n)
    if args.write:
        out = os.path.join(RESULTS_DIR, "roofline_tables.md")
        with open(out, "w") as f:
            f.write(f"## Roofline baseline ({args.mesh} mesh, per chip; "
                    f"counted on fake tensors, not measured; H100 SXM5)\n\n")
            f.write(t + "\n\n## NMF workloads (paper dry-run cells)\n\n")
            f.write(n + "\n")
        print("wrote", os.path.abspath(out))


if __name__ == "__main__":
    main()
