"""Deterministic fault injection for the elastic runtime — a copy of
``repro/elastic/faults.py`` (plain Python, no JAX).

Chaos that replays: every fault here is keyed on the global iteration
count at a segment boundary — never on wall clock, PIDs, or randomness —
so a failing chaos run reproduces bit-identically from its seed and plan.
Three fault families, matching the three ways real runs die:

  * **hard crash** (``crash_at``) — :class:`InjectedFault` raised right
    after a step's checkpoint published, standing in for process death;
    the next ``ElasticRunner.fit`` call must auto-restore.
  * **storage faults** (``torn_at`` / ``corrupt_at`` / ``truncate_at``) —
    the published payload is torn (crash between ``write_payload``'s two
    renames: ``final`` vanishes, the previous version survives as
    ``.old_<base>_<pid>``), bit-rotted, or truncated.  The restore scan
    must recover the torn case (``checkpoint.recover_payload``) and fall
    back past the corrupt/truncated ones (``CheckpointCorrupt``).
  * **transient faults** (``transient_at``) — :class:`TransientFault`
    raised at a segment's start a planned number of times, standing in
    for flaky devices/filesystems; :class:`RetryPolicy` bounds the
    retries with deterministic backoff.
"""

from __future__ import annotations

import dataclasses
import os


class InjectedFault(RuntimeError):
    """A planned hard crash (process-death stand-in).  Not retryable:
    the runner lets it propagate; recovery is the next fit() call's
    auto-restore."""


class TransientFault(RuntimeError):
    """A planned retryable failure (flaky device / filesystem stand-in).
    The runner retries the segment under its :class:`RetryPolicy`."""


def torn_save(path: str) -> None:
    """Simulate a crash inside ``write_payload``'s only non-atomic window:
    the published payload moves aside to ``.old_<base>_<pid>`` and the
    final directory vanishes — exactly the on-disk state between the two
    renames.  ``checkpoint.recover_payload`` must bring it back."""
    parent = os.path.dirname(path) or "."
    base = os.path.basename(path)
    os.replace(path, os.path.join(parent, f".old_{base}_{os.getpid()}"))


def corrupt_payload(path: str, *, offset: int = -64, nbytes: int = 8) -> None:
    """Flip ``nbytes`` bytes of ``arrays.npz`` at ``offset`` (negative =
    from the end) — bit rot the checksum pass in ``read_payload`` must
    catch."""
    npz = os.path.join(path, "arrays.npz")
    off = offset % os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.seek(off)
        chunk = f.read(nbytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))


def truncate_payload(path: str, *, keep: int = 128) -> None:
    """Cut ``arrays.npz`` down to ``keep`` bytes — the half-written /
    out-of-disk failure mode.  ``read_payload`` surfaces it as
    ``CheckpointCorrupt`` (unreadable zip)."""
    npz = os.path.join(path, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(keep)


@dataclasses.dataclass
class FaultPlan:
    """What goes wrong, and exactly when.  All step numbers are global
    iteration counts at segment boundaries; the storage faults and crashes
    fire right after that step's checkpoint published (``after_save``),
    transients fire before the segment that STARTS at that step runs
    (``before_segment``)."""

    crash_at: tuple = ()
    torn_at: tuple = ()
    corrupt_at: tuple = ()
    truncate_at: tuple = ()
    #: step -> how many times the segment starting there fails before
    #: succeeding (consumed across retries, so a bounded RetryPolicy wins).
    transient_at: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._transient_left = dict(self.transient_at)

    def before_segment(self, step: int) -> None:
        left = self._transient_left.get(step, 0)
        if left > 0:
            self._transient_left[step] = left - 1
            raise TransientFault(
                f"injected transient fault before the segment at step "
                f"{step} ({left - 1} more planned)")

    def after_save(self, step: int, path: str) -> None:
        if step in self.corrupt_at:
            corrupt_payload(path)
        if step in self.truncate_at:
            truncate_payload(path)
        if step in self.torn_at:
            torn_save(path)
        if step in self.crash_at:
            raise InjectedFault(
                f"injected crash after the checkpoint at step {step}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with deterministic exponential backoff for
    :class:`TransientFault`.  ``max_retries=0`` turns retries off (the
    first transient propagates)."""

    max_retries: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0

    def delay(self, attempt: int) -> float:
        """Seconds to sleep before retry ``attempt`` (0-based)."""
        return self.backoff_s * (self.backoff_factor ** attempt)
