"""The comparison that decides ``correct``.

The program's outputs of one segment, the factors W (m, k), Hᵀ (n, k) and
the relative error after each iteration, are held against the plain
reference's from the same inputs (``reference.segment``), and the
program's last relative error against the exact one of its own factors
(``reference.rel_error`` in float64).  The numbers:

    w_row, h_row   the worst row's gap: max over rows i of
                   ‖X_i − X*_i‖ / max(‖X*_i‖, the median ‖X*_j‖), X* the
                   reference's (W rows, or columns of H); each row is one
                   answer, and the median keeps all-but-empty rows from
                   dividing by nothing
    w_frob, h_frob ‖X − X*‖_F / ‖X*‖_F
    rel_traj       max over iterations of |e − e*| / e*, e the program's
                   relative error and e* the reference's
    rel_self       |e_last − ê| / ê, ê the exact relative error of the
                   program's own last factors

A cell's limits file names the numbers it compares and their limits; a
number that is not finite fails.
"""

from __future__ import annotations

import math

import torch

#: rows per chunk of the row gaps (the factors of the sparse cells are
#: 3.4 GB each)
CHUNK_ROWS = 1 << 22


def row_gaps(X: torch.Tensor, Xr: torch.Tensor):
    """(‖X_i − Xr_i‖, ‖Xr_i‖) of every row i, float64."""
    diff = torch.empty(X.shape[0], dtype=torch.float64, device=X.device)
    norm = torch.empty_like(diff)
    for r0 in range(0, X.shape[0], CHUNK_ROWS):
        x = X[r0:r0 + CHUNK_ROWS].double()
        xr = Xr[r0:r0 + CHUNK_ROWS].to(x.device).double()
        diff[r0:r0 + CHUNK_ROWS] = (x - xr).norm(dim=1)
        norm[r0:r0 + CHUNK_ROWS] = xr.norm(dim=1)
    return diff, norm


def _gaps(X: torch.Tensor, Xr: torch.Tensor) -> tuple[float, float]:
    """(worst row gap, Frobenius gap) of X against the reference's Xr."""
    diff, norm = row_gaps(X, Xr)
    floor = norm.median().clamp_min(torch.finfo(torch.float64).tiny)
    row = (diff / torch.maximum(norm, floor)).max()
    frob = diff.norm() / norm.norm().clamp_min(torch.finfo(torch.float64).tiny)
    return float(row), float(frob)


def numbers(out: dict, ref: dict, rel_exact: float, gaps=_gaps) -> dict:
    """Every number above for the program's ``out`` and the reference's
    ``ref`` (dicts of "W", "Ht", "rels"); ``gaps`` takes the two row gaps
    (the rows of every rank, on a grid: ``ranks.Ranks.gaps``)."""
    w_row, w_frob = gaps(out["W"], ref["W"])
    h_row, h_frob = gaps(out["Ht"], ref["Ht"])
    rels, rels_ref = list(out["rels"]), list(ref["rels"])
    if len(rels) != len(rels_ref):
        traj = math.inf
    else:
        traj = max(abs(a - b) / b for a, b in zip(rels, rels_ref))
    return {"w_row": w_row, "h_row": h_row, "w_frob": w_frob,
            "h_frob": h_frob, "rel_traj": traj,
            "rel_self": abs(rels[-1] - rel_exact) / rel_exact}


def decide(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; no limits at all is not correct."""
    checks = {name: {"value": nums.get(name, math.nan), "limit": limit}
              for name, limit in limits.items()}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
