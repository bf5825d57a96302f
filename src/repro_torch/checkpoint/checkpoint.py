"""Atomic, checksummed payload directories — the counterpart of the payload
half of ``repro/checkpoint/checkpoint.py`` (``CheckpointCorrupt``,
``_checksum``, ``write_payload``, ``read_payload``).

A payload is a directory holding ``arrays.npz`` and ``meta.json``, written
to a tmp dir and ``os.replace``d into place, with a CRC-32 per array in
``meta.json`` under ``"checksums"``.  The format and the checksum string are
the reference's, so a payload written by either package verifies in the
other.  Only numpy and the standard library are used: the arrays cross as
numpy arrays.  Train checkpoints, ``recover_payload`` and the async
checkpointer are not ported yet (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib

import numpy as np


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
