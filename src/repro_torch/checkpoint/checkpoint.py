"""Atomic, checksummed, async checkpointing with auto-restore — the
counterpart of ``repro/checkpoint/checkpoint.py``.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a tmp dir
and ``os.replace``d into place (``write_payload``), so a crash mid-save can
never corrupt the latest checkpoint; ``keep_last`` old steps are pruned.
``meta.json`` holds a CRC-32 per array under ``"checksums"``, and
``read_payload`` verifies it (a mismatch raises ``CheckpointCorrupt``).
``recover_payload`` repairs the one non-atomic window of ``write_payload``:
a crash between moving the old payload aside and publishing the new one.

``save`` / ``restore`` flatten nested dicts, lists, tuples and NamedTuples
of tensors (or numpy arrays, or Python scalars) into the reference's
``"::"``-joined key paths: a dict key as itself (dicts in sorted key
order), a list or tuple index as its number, a NamedTuple field as
``.<field>`` (JAX's ``GetAttrKey``); None holds no leaf.  The format, the
key strings and the checksums are the reference's, so a step directory
written by either package restores in the other, key for key and bit for
bit.  numpy has no bfloat16: bf16 tensors are saved as float32 (exact)
and restored in the template's dtype.  ``AsyncCheckpointer`` copies the
state to the host before its writer thread starts.  Only numpy, torch and
the standard library are used.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

_SEP = "::"


class CheckpointCorrupt(RuntimeError):
    """A payload failed to load or verify: missing file, unreadable npz,
    or an array whose bytes no longer match the checksum recorded at write
    time."""


def _checksum(arr: np.ndarray) -> str:
    """CRC-32 over the array bytes + dtype/shape (cheap, catches truncation
    and bit rot; not cryptographic)."""
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(a.tobytes())
    return f"crc32:{crc:08x}:{a.dtype.str}:{'x'.join(map(str, a.shape))}"


def write_payload(final: str, arrays: dict[str, np.ndarray],
                  meta: dict) -> str:
    """Publish ``arrays.npz`` + ``meta.json`` as directory ``final`` without
    ever exposing a torn payload: everything lands in a tmp dir first, and
    on overwrite the previous payload is moved aside before the
    ``os.replace`` and deleted only after the new one is in place.  A
    per-array checksum lands in ``meta.json`` under ``"checksums"``."""
    parent = os.path.dirname(final) or "."
    os.makedirs(parent, exist_ok=True)
    base = os.path.basename(final)
    tmp = os.path.join(parent, f".tmp_{base}_{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = dict(meta)
    meta["checksums"] = {k: _checksum(np.asarray(v))
                         for k, v in arrays.items()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    old = os.path.join(parent, f".old_{base}_{os.getpid()}")
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(final, old)       # keep the previous payload intact
    os.replace(tmp, final)           # atomic publish
    shutil.rmtree(old, ignore_errors=True)
    return final


def read_payload(path: str, *, verify: bool = True
                 ) -> tuple[dict[str, np.ndarray], dict]:
    """Load a ``write_payload`` directory back as (arrays, meta).  With
    ``verify`` every array whose checksum was recorded is re-hashed; a
    mismatch, truncation or unreadable file raises ``CheckpointCorrupt``."""
    npz = os.path.join(path, "arrays.npz")
    try:
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile, zlib.error, NotImplementedError) as e:
        # NotImplementedError: flipped bits in the zip central directory
        # masquerade as an unsupported compression method.
        raise CheckpointCorrupt(f"unreadable payload {path}: "
                                f"{type(e).__name__}: {e}") from e
    if verify:
        sums = meta.get("checksums")
        if sums is not None:
            missing = set(sums) - set(arrays)
            if missing:
                raise CheckpointCorrupt(
                    f"payload {path} is missing arrays {sorted(missing)} "
                    f"recorded in its manifest")
            for name, expect in sums.items():
                got = _checksum(arrays[name])
                if got != expect:
                    raise CheckpointCorrupt(
                        f"payload {path} array {name!r} failed its "
                        f"checksum (expected {expect}, got {got})")
    return arrays, meta


def recover_payload(final: str) -> bool:
    """Repair the crash-between-renames window of ``write_payload``: if
    ``final`` is absent but a ``.old_<base>_<pid>`` sibling survives, move
    the newest one back into place.  Returns True when a recovery
    happened.  Leftover ``.tmp_*`` dirs for this base (saves that died
    mid-write) are deleted either way: they may be half-written and must
    never be promoted."""
    parent = os.path.dirname(final) or "."
    base = os.path.basename(final)
    for tmp in glob.glob(os.path.join(parent, f".tmp_{base}_*")):
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(final):
        return False
    olds = glob.glob(os.path.join(parent, f".old_{base}_*"))
    if not olds:
        return False
    olds.sort(key=os.path.getmtime)
    os.replace(olds[-1], final)
    for stale in olds[:-1]:
        shutil.rmtree(stale, ignore_errors=True)
    return True


# ---------------------------------------------------------------------------
# Train checkpoints: nested containers of tensors <-> "::"-joined key paths
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_leaves(tree, fn, path=()):
    """``tree`` with every leaf replaced by ``fn(key path, leaf)``, the key
    path a tuple of the reference's key strings (dicts visited in sorted
    key order, as JAX flattens them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_leaves(tree[key], fn, path + (str(key),))
                for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(getattr(tree, name), fn,
                                        path + (f".{name}",))
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _as_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array (a CPU tensor's shares its memory)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    """{"::"-joined key path: array}, the reference's flattening: a dict
    key as itself, a list or tuple index as its number, a NamedTuple field
    as ``.<field>``; None holds no leaf."""
    flat = {}
    _map_leaves(tree, lambda path, x: flat.__setitem__(_SEP.join(path),
                                                        _as_numpy(x)))
    return flat


def _snapshot(leaf):
    """A host copy of a leaf that shares no memory with the caller's."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save(state, step: int, ckpt_dir: str, *, keep_last: int = 3,
         extra_meta: dict | None = None) -> str:
    """Write ``state`` as ``<ckpt_dir>/step_<step:08d>`` (``write_payload``)
    and prune all but the last ``keep_last`` steps; returns the path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(state)
    meta = {"step": step, "time": time.time(), "keys": sorted(flat),
            **(extra_meta or {})}
    write_payload(final, flat, meta)
    _prune(ckpt_dir, keep_last)
    return final


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, template, *, step: int | None = None,
            device=None):
    """Restore the step ``step`` (None: the newest) into the structure of
    ``template``: each leaf a tensor of the template leaf's dtype and shape
    (a shape that differs raises ``ValueError``), on ``device`` (None: the
    template tensor's own device, the CPU for a numpy leaf).  Returns
    ``(state, step)``, or ``(None, None)`` when there is no checkpoint.
    The arrays are read as the reference reads them, without verifying
    their checksums."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    def leaf(key_path, tmpl):
        key = _SEP.join(key_path)
        if key not in flat:
            raise KeyError(f"checkpoint {path} has no array {key!r}")
        arr = flat[key]
        want = tmpl if isinstance(tmpl, torch.Tensor) else torch.as_tensor(
            np.asarray(tmpl))
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint array {key!r} has shape "
                             f"{tuple(arr.shape)}, the template "
                             f"{tuple(want.shape)}")
        dev = want.device if device is None else torch.device(device)
        return torch.as_tensor(arr).to(device=dev, dtype=want.dtype)

    return _map_leaves(template, leaf), step


class AsyncCheckpointer:
    """One-slot async writer: ``save()`` copies the state to the host and
    returns; the file is written by a thread; the next ``save()`` (or
    ``wait()``) joins the previous write.  At most one checkpoint is in
    flight.  A failed write raises from the ``wait()`` (or ``save()``)
    that joins it."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_path: str | None = None

    def save(self, state, step: int, **kw) -> None:
        self.wait()
        # copied before the thread starts: the caller may go on writing
        # its tensors the moment this returns
        host_state = _map_leaves(state, lambda _path, x: _snapshot(x))

        def run():
            try:
                self.last_path = save(host_state, step, self.ckpt_dir,
                                      keep_last=self.keep_last, **kw)
            except Exception as e:          # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
