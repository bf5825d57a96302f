"""Drift accounting for the online train→serve loop — the counterpart of
``repro/online/drift.py``.

The online loop folds every arriving row batch into the latent space with
the CURRENT factors (warm start) — cheap, but it never updates H, so model
quality decays as the data distribution moves.  The decision of *when* to
pay for a refresh, and *how much* of one, is this module's job.

The signal is the fold-in residual itself: after projecting a batch
``rows`` to codes ``X``, the per-entry energy of ``rows − X·H`` says how
well the current H explains the new data.  Training left a baseline — the
final relative error of the fit (``NMFResult.rel_errors[-1]``, carried in
the artifact's provenance) — so anything ABOVE ``baseline_rel_err²`` of
the ingested energy is *excess*: unexplained structure the factors have
not absorbed.  ``DriftAccumulator`` integrates that excess, resolved onto
a fixed partition of H's columns into ``n_blocks`` contiguous feature
blocks:

    drift_b  +=  max(0, ‖E[:, block b]‖² − baseline² · ‖rows[:, block b]‖²)
                 ───────────────────────────────────────────────────────────
                              ‖rows‖²  (per-batch normaliser)

so accumulated drift is in units of "batches' worth of excess energy" —
scale-free in the data and comparable across block sizes.  Two thresholds
consume it (the DID split, arXiv:1802.08938):

  * a block whose drift exceeds ``block_threshold`` is *touched* — worth a
    cheap partial H refresh (``UpdateRule.partial_update_h`` on just those
    columns);
  * total drift beyond ``full_threshold`` schedules a FULL warm-started
    refactorization through ``NMFSolver.fit(init=...)``.

``reset(mask)`` clears exactly the blocks a refresh repaired;
``reset_all()`` follows a full refactorization (which also rebases the
baseline on the new fit's final error).

The energies are computed in fp32 on the rows' device (the residual is a
plain ``torch.matmul``, as the reference's is a plain product); the
accumulated drift stays float64 on the host, as the reference's.
"""

from __future__ import annotations

import numpy as np
import torch


def block_residual_energy(rows: torch.Tensor, X: torch.Tensor,
                          H: torch.Tensor, *, n_blocks: int):
    """Per-feature-block (residual², ingested²) energies of one batch.

    ``rows`` (b, n) dense, ``X`` (b, k) fold-in codes, ``H`` (k, n), all on
    one device.  Columns map to ``n_blocks`` contiguous blocks (block
    widths differ by at most one when ``n_blocks`` does not divide n).
    Returns ``(res_sq, row_sq)``, both (n_blocks,) fp32 on the rows'
    device.
    """
    n = rows.shape[1]
    E = (rows - X @ H).float()
    ids = torch.arange(n, device=rows.device) * n_blocks // n   # balanced

    def seg(col_sums):
        out = torch.zeros(n_blocks, dtype=torch.float32, device=rows.device)
        return out.index_add_(0, ids, col_sums)

    res = seg(torch.sum(torch.square(E), dim=0))
    raw = seg(torch.sum(torch.square(rows.float()), dim=0))
    return res, raw


def block_slices(n: int, n_blocks: int) -> list[slice]:
    """The column ranges of the balanced contiguous partition
    ``block_residual_energy`` scores against (block b = columns with
    ``col · n_blocks // n == b``)."""
    ids = np.arange(n) * n_blocks // n
    return [slice(int(np.searchsorted(ids, b)),
                  int(np.searchsorted(ids, b, side="right")))
            for b in range(n_blocks)]


class DriftAccumulator:
    """Integrates per-block excess fold-in residual into refresh decisions.

    >>> acc = DriftAccumulator(n=64, n_blocks=8, baseline_rel_err=0.02)
    >>> acc.observe(rows, X, H)              # after each fold-in
    >>> if acc.should_refactor(): ...        # full warm-started refit
    >>> elif acc.touched().any(): ...        # partial H refresh
    """

    def __init__(self, n: int, *, n_blocks: int = 8,
                 baseline_rel_err: float = 0.0,
                 block_threshold: float = 0.25,
                 full_threshold: float = 2.0):
        if n_blocks < 1 or n_blocks > n:
            raise ValueError(f"n_blocks must be in [1, n={n}], got "
                             f"{n_blocks}")
        if block_threshold < 0 or full_threshold < 0:
            raise ValueError("thresholds must be >= 0")
        self.n, self.n_blocks = int(n), int(n_blocks)
        self.block_threshold = float(block_threshold)
        self.full_threshold = float(full_threshold)
        self.baseline_rel_err = float(baseline_rel_err)
        self._drift = np.zeros(self.n_blocks, np.float64)
        self.batches_seen = 0

    @property
    def drift(self) -> np.ndarray:
        """Accumulated per-block excess (copy; (n_blocks,) fp64)."""
        return self._drift.copy()

    @property
    def total(self) -> float:
        return float(self._drift.sum())

    def observe(self, rows, X, H) -> np.ndarray:
        """Fold one ingested batch's residual into the accumulator;
        returns this batch's per-block excess contribution.  ``rows``,
        ``X`` and ``H`` are tensors (or numpy arrays) on one device."""
        dev = rows.device if isinstance(rows, torch.Tensor) else "cpu"
        rows, X, H = (torch.as_tensor(v, device=dev) for v in (rows, X, H))
        res, raw = block_residual_energy(rows, X, H, n_blocks=self.n_blocks)
        res = res.cpu().numpy().astype(np.float64)
        raw = raw.cpu().numpy().astype(np.float64)
        total = max(raw.sum(), np.finfo(np.float64).tiny)
        excess = np.maximum(res - self.baseline_rel_err ** 2 * raw,
                            0.0) / total
        self._drift += excess
        self.batches_seen += 1
        return excess

    def touched(self) -> np.ndarray:
        """Boolean (n_blocks,): blocks whose drift warrants a partial
        refresh."""
        return self._drift > self.block_threshold

    def should_refactor(self) -> bool:
        """Total drift beyond ``full_threshold`` — schedule a full
        warm-started refactorization instead of patching blocks."""
        return self.total > self.full_threshold

    def column_mask(self, touched=None) -> np.ndarray:
        """Expand a touched-block vector to a boolean column mask (n,)."""
        touched = self.touched() if touched is None else np.asarray(touched)
        ids = np.arange(self.n) * self.n_blocks // self.n
        return touched[ids]

    def reset(self, touched) -> None:
        """Clear the blocks a partial refresh just repaired."""
        self._drift[np.asarray(touched, bool)] = 0.0

    def reset_all(self, *, baseline_rel_err: float | None = None) -> None:
        """Clear everything after a full refactorization; optionally rebase
        the baseline on the new fit's final relative error."""
        self._drift[:] = 0.0
        if baseline_rel_err is not None:
            self.baseline_rel_err = float(baseline_rel_err)
