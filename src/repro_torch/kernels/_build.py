"""Build and load the keyed plane's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  One ``nvcc`` call
compiles all of them for ``sm_90a`` into one shared library under the
repository's ``build/`` directory (listed in ``.gitignore``); the file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library.  The library is loaded with
``ctypes``: every pointer and the stream are ``c_void_p``, every function
returns ``cudaGetLastError()``.

Nothing here runs at import time.  :func:`library` builds on first use, so
``python3 chip_smoke.py`` alone builds everything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_SCATTER_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
_SIGNATURES = {
    "keyed_segment_sum_i32": _SCATTER_ARGS,
    "keyed_segment_sum_f32": _SCATTER_ARGS,
    "keyed_scatter_add_i64": _SCATTER_ARGS,
    "keyed_scatter_add_i32": _SCATTER_ARGS,
    "keyed_scatter_add_f32": _SCATTER_ARGS,
    "keyed_table_lookup": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P],
    "keyed_batched_table_lookup":
        [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

#: what the last build did: seconds, whether it compiled, ptxas report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the keyed kernels")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``csrc/*.cu`` into one shared library; returns its path."""
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = Path(build_dir) / f"libkeyed_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if out.exists():
        BUILD_INFO.update(seconds=time.perf_counter() - t0, compiled=False,
                          path=str(out), ptxas="")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, compiled=True,
                      path=str(out), ptxas=proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB
