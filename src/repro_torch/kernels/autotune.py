"""Measured-search autotuner with a persistent JSON cache — the counterpart
of ``repro/kernels/autotune.py``.

``tune(op, key_parts, candidates, run)`` times every candidate
configuration on synthetic inputs of the caller's exact shapes and dtypes
(one warm-up call, then the best of ``repeats``) and returns the fastest.
The port's kernels run on fixed tiles and pure plans (``kernels/ops.py``
``plan_*``), so the one caller is the top-k streaming tile
(``serve/topk.py``, ``TopK(chunk=None)``).  Results persist in a JSON file
so the search runs once per (op, shape, dtype, device), across processes.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json``.  The file maps key → entry, the
reference's schema::

    {"topk_chunk|1013400|50|1|10|cosine|NVIDIA H100 80GB HBM3": {
        "params": [8192],
        "times_us": {"(512,)": 812.4, "(4096,)": 401.2, ...},
        "chosen_us": 390.1}}

``params`` is what the caller uses; ``times_us`` keeps the whole search.
The key is op|shape parts|device, the device part
``torch.cuda.get_device_name()`` or ``cpu``.  The caller's hand default
is always among the candidates, so the tuned choice is never slower than
it (up to timer noise).

The reference runs its search in a worker thread, to measure outside
JAX's (thread-local) trace context; eager PyTorch has no trace context, so
the port measures on the calling thread.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Iterable, Sequence

import torch

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_PATH = "~/.cache/repro_torch/autotune.json"

# In-memory mirror of the cache file (per cache path, so tests that
# repoint the env var do not see stale entries).
_cache: dict[str, dict] = {}
_cache_for: str | None = None


def cache_path() -> Path:
    return Path(os.environ.get(CACHE_ENV) or _DEFAULT_PATH).expanduser()


def _load() -> dict[str, dict]:
    global _cache, _cache_for
    path = str(cache_path())
    if _cache_for != path:
        _cache_for = path
        try:
            with open(path) as f:
                _cache = json.load(f)
        except (OSError, ValueError):
            _cache = {}
        if not isinstance(_cache, dict):
            _cache = {}
    return _cache


def _persist() -> None:
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(_cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass        # read-only file system: keep the in-memory result


def clear(*, memory_only: bool = True) -> None:
    """Drop cached tunings.  With ``memory_only=False`` also remove the
    cache file."""
    global _cache, _cache_for
    _cache, _cache_for = {}, None
    if not memory_only:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def _device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def make_key(op: str, key_parts: Iterable, device="cpu") -> str:
    """Stable cache key: the op name, the caller's shape/dtype parts and
    the device the search ran on (``torch.cuda.get_device_name()`` or
    ``cpu``: timings from two devices are not comparable)."""
    parts = "|".join(str(p) for p in key_parts)
    return f"{op}|{parts}|{_device_name(device)}"


def measure(run: Callable[[], object], *, repeats: int = 2,
            device="cpu") -> float:
    """Best-of-``repeats`` seconds of ``run`` after one warm-up call.  On a
    CUDA ``device`` each call is timed with CUDA events around it and the
    device synchronised; on the CPU with the host clock."""
    dev = torch.device(device)
    run()
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def _entry_params(entry) -> tuple | None:
    """Params of a cache entry, or None for anything schema-invalid (the
    file is shared and hand-editable: a mangled entry reads as a miss)."""
    if not isinstance(entry, dict):
        return None
    params = entry.get("params")
    if isinstance(params, list) and params:
        return tuple(params)
    return None


def lookup(op: str, key_parts: Iterable, device="cpu") -> tuple | None:
    return _entry_params(_load().get(make_key(op, key_parts, device)))


def tune(op: str, key_parts: Iterable, candidates: Sequence[tuple],
         run: Callable[[tuple], object], *, repeats: int = 3,
         device="cpu") -> tuple:
    """The measured search.  ``candidates`` are parameter tuples (the hand
    default must be among them); ``run(params)`` runs the operation once
    with those parameters on synthetic inputs on ``device``.  Returns the
    fastest tuple, consulting and updating the persistent cache."""
    if not candidates:
        raise ValueError("tune needs at least one candidate")
    key = make_key(op, key_parts, device)
    cache = _load()
    cached = _entry_params(cache.get(key))
    if cached is not None and cached in {tuple(c) for c in candidates}:
        return cached
    times: dict[str, float] = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        t = measure(lambda: run(cand), repeats=repeats, device=device)
        times[str(tuple(cand))] = round(t * 1e6, 2)
        if t < best_t:
            best, best_t = tuple(cand), t
    cache[key] = {"params": list(best), "times_us": times,
                  "chosen_us": round(best_t * 1e6, 2)}
    _persist()
    return best
