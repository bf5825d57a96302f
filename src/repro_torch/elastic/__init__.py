"""Elastic runtime: checkpointed segmented training with fault injection
and pr×pc re-meshing — the counterpart of ``repro.elastic``.

* ``repro_torch.elastic.runner`` — :class:`ElasticRunner`: fit in
  fixed-iteration segments, snapshot full resumable state at every
  boundary (async, atomic, checksummed, the reference's payload), auto-
  restore from the newest valid checkpoint; bit-identical resume on the
  exact wire format.
* ``repro_torch.elastic.remesh`` — resume on another pr×pc grid / process
  group / schedule / backend (checkpoints are mesh-agnostic).
* ``repro_torch.elastic.faults`` — deterministic chaos: planned crashes,
  torn saves, corruption, transients + bounded retry.
"""

from repro_torch.elastic.faults import (FaultPlan, InjectedFault,
                                        RetryPolicy, TransientFault,
                                        corrupt_payload, torn_save,
                                        truncate_payload)
from repro_torch.elastic.remesh import (ElasticCheckpoint, load_checkpoint,
                                        remesh_solver, resume)
from repro_torch.elastic.runner import (ENFORCED_FINGERPRINT,
                                        CheckpointMismatch, ElasticRunner)

__all__ = [
    "CheckpointMismatch", "ENFORCED_FINGERPRINT", "ElasticCheckpoint",
    "ElasticRunner", "FaultPlan", "InjectedFault", "RetryPolicy",
    "TransientFault", "corrupt_payload", "load_checkpoint",
    "remesh_solver", "resume", "torn_save", "truncate_payload",
]
