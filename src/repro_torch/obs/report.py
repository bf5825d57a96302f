"""Measured-against-predicted phase breakdown — the paper's Fig. 7 analog.
Counterpart of ``repro/obs/report.py``.

Joins the segmented timings of ``NMFSolver.fit(profile=True)``
(``extras["phase_times"]``, seconds per iteration per phase) with the
α-β-γ model's per-group predictions (``costmodel.schedule_cost_terms``) on
the shared group key gram / mm / luc / comm / error.  The ratio column
(measured / predicted) shows where the model is wrong on real hardware:
pass ``machine=Machine(<the card's α, β, γ>)``, since the default
``Machine`` is the paper's Rhea cluster, not the card.

    from repro_torch.obs.report import breakdown_report, format_report
    rows = breakdown_report(solver, result, m, n)
    print(format_report(rows))

``python -m repro_torch.obs.report [--device cpu]`` runs all four
schedules on a small synthetic problem (the distributed ones on a
one-rank process group) and prints one table per schedule.
"""

from __future__ import annotations

import argparse

from repro_torch.obs.phases import phase_group


def merge_phase_times(phase_times: dict) -> dict:
    """Collapse measured per-phase seconds onto the cost-model groups
    (gram / mm / luc / comm / error; see ``phases.phase_group``)."""
    out: dict[str, float] = {}
    for phase, sec in phase_times.items():
        g = phase_group(phase)
        out[g] = out.get(g, 0.0) + sec
    return out


def breakdown_report(solver, result, m: int, n: int, *, nnz: float = 0.0,
                     machine=None) -> list[dict]:
    """Rows of {group, measured_s, predicted_s, ratio} joining a profiled
    fit with the solver's cost-model terms.

    Only groups the schedule measures appear (serial has no comm phases,
    so no comm row): ``ratio`` is measured/predicted, or the string
    ``"n/a"`` when the model predicts exactly zero for a measured group.
    """
    phase_times = result.extras.get("phase_times")
    if phase_times is None:
        raise ValueError("result has no phase_times — run "
                         "solver.fit(A, profile=True)")
    measured = merge_phase_times(phase_times)
    predicted = solver.predict_cost_terms(m, n, nnz=nnz, machine=machine)
    rows = []
    for group in ("gram", "mm", "luc", "comm", "error"):
        if group not in measured:
            continue
        meas, pred = measured[group], predicted.get(group, 0.0)
        ratio = meas / pred if pred > 0 else "n/a"
        rows.append({"group": group, "measured_s": meas,
                     "predicted_s": pred, "ratio": ratio})
    return rows


def format_report(rows: list[dict], *, title: str = "") -> str:
    """Fixed-width table of a ``breakdown_report`` result."""
    lines = []
    if title:
        lines.append(title)
    lines.append(f"{'phase':<8} {'measured_s':>12} {'predicted_s':>12} "
                 f"{'ratio':>10}")
    for r in rows:
        ratio = r["ratio"]
        ratio_s = ratio if isinstance(ratio, str) else f"{ratio:10.2f}"
        lines.append(f"{r['group']:<8} {r['measured_s']:>12.3e} "
                     f"{r['predicted_s']:>12.3e} {ratio_s:>10}")
    return "\n".join(lines)


def run_all_schedules(m: int = 96, n: int = 64, k: int = 8, *,
                      iters: int = 3, algo: str = "mu",
                      backend: str = "dense", device=None,
                      seed: int = 0) -> dict[str, list[dict]]:
    """Profile every schedule on one synthetic uniform (m, n) problem on
    ``device`` (None: ``cuda``); returns {schedule: breakdown rows}.  The
    distributed schedules run on a one-rank process group made for the
    call (``util.dist.one_rank_group``: NCCL on the card, gloo on the
    CPU).  Small by design: the smoke-size protocol."""
    import torch

    from repro_torch.core.engine import NMFSolver
    from repro_torch.core.faun import make_faun_grid
    from repro_torch.util.device import make_generator, resolve_device
    from repro_torch.util.dist import one_rank_group

    dev = resolve_device(device)
    A = torch.rand((m, n), generator=make_generator(dev, seed), device=dev)
    out = {}
    with one_rank_group(dev):
        grid = make_faun_grid(1, 1)
        for schedule in ("serial", "faun", "naive", "gspmd"):
            solver = NMFSolver(k, algo=algo, schedule=schedule,
                               backend=backend, device=dev, max_iters=iters,
                               grid=None if schedule == "naive" else grid)
            res = solver.fit(A, profile=True)
            out[schedule] = breakdown_report(solver, res, m, n)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    reports = run_all_schedules(device=args.device)
    for schedule, rows in reports.items():
        print(format_report(rows, title=f"-- {schedule} --"))
        print()


if __name__ == "__main__":
    main()
