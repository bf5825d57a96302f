"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/<name>-<digest>.so`` at the root of the
checkout, on first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<digest>.so <name>.cu

The digest covers the source, the shared headers and the flags, so an
edited kernel is rebuilt and a stale library is never loaded.  ``nvcc``'s
output (``-Xptxas -v``: registers, shared memory and spills per kernel) is
kept beside the library as ``<name>-<digest>.log``.  ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them all.

Nothing here runs at import time: this module imports on machines without
``nvcc``, and only a kernel launch on a CUDA tensor reaches ``load``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("ts_matmul", "gram", "spmm", "luc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
#: C entry points of each library: name -> argtypes (all return an int,
#: the CUDA error code of the launch; 0 is success).  ``<name>_tiles``
#: writes the tile sizes the library was compiled with; ``luc_max_k`` the
#: largest k of the LUC kernels.
SIGNATURES = {
    "ts_matmul": {
        "ts_matmul_launch": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                             _I64, _I, _I, _P],
        "ts_matmul_t_launch": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                               _I64, _I, _I, _P],
        "ts_matmul_tiles": [_IP],
    },
    "gram": {
        "gram_launch": [_I, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I,
                        _P],
        "gram_tiles": [_IP],
    },
    "spmm": {
        "spmm_launch": [_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                        _I, _I, _I64, _I64, _P, _P, _P, _P, _P],
        "spmm_sorted_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                               _I64, _I64, _I64, _P],
    },
    "luc": {
        "luc_launch": [_I, _I, _I, _P, _P, _P, _P, _I64, _I64, _F, _P],
        "luc_max_k": [_IP],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built on first use")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, all started together; returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = []
    try:
        for name, path in paths.items():
            if path.exists():
                continue
            tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
            cmd = nvcc_command(name, tmp)
            with open(path.with_suffix(".log"), "w") as log:  # nvcc keeps a copy
                running.append((name, path, tmp, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
    finally:   # every nvcc started is waited for, even if a later one fails
        done = [(name, path, tmp, proc.wait())
                for name, path, tmp, proc in running]
    failed = []
    for name, path, tmp, rc in done:
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          f"{path.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with the
    ``argtypes``/``restype`` of its C entry points set."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib
