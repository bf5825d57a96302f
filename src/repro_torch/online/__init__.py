"""Streaming OnlineNMF: ingest a growing row stream while serving top-k —
the counterpart of ``repro.online``.

``OnlineNMF`` closes the train→serve loop: arriving batches are folded in
as warm starts, a ``DriftAccumulator`` decides between cheap W-extension
publishes, DID-style touched-block H refreshes, and full warm-started
refactorizations, and every publish lands atomically through the
versioned ``FactorArtifact`` lineage so concurrent clients never see
mixed-version factors.
"""

from repro_torch.online.drift import (DriftAccumulator,
                                      block_residual_energy, block_slices)
from repro_torch.online.service import (IngestReport, OnlineNMF,
                                        OnlineStats, ServeResult)

__all__ = [
    "OnlineNMF", "OnlineStats", "IngestReport", "ServeResult",
    "DriftAccumulator", "block_residual_energy", "block_slices",
]
