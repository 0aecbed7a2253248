"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  Each ``.cu`` file is
compiled by its own ``nvcc`` call for ``sm_90a`` into its own shared
library under the repository's ``build/`` directory (listed in
``.gitignore``); the calls for the libraries that are missing all start
together, so the build takes about as long as its slowest source.  A file
name carries a hash of its source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads the existing library.
The libraries are loaded with ``ctypes.PyDLL``: every pointer and the
stream are ``c_void_p``, every function returns ``cudaGetLastError()``.

Every kernel wrapper launches through the two helpers here, which keep the
host's time per call near that of one PyTorch operator:

- :func:`check_cuda` checks that the tensors are contiguous and on one CUDA
  device in one pass of cheap tensor properties, and returns the device's
  index; only a refusal builds a message;
- :func:`launch` calls an entry point resolved once by name (no lock once
  the libraries are loaded), on the raw current stream of that device (no
  ``torch.cuda.Stream`` object), entering a device context only when the
  tensors are not on the current device, and raises ``RuntimeError`` on a
  nonzero return code.

Nothing here runs at import time.  :func:`library` builds on first use, so
``python3 chip_smoke.py`` alone builds everything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import resource
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # int64[3]
_SCATTER_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]
# ids, values, out, R, d, S, workspace (tile counter and look-back
# records), tiles claimed from its counter before this call, stream
_SORTED_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                _P, ctypes.c_ulonglong, _P]
_SIGNATURES = {
    "keyed_segment_sum_sorted_i32": _SORTED_ARGS,
    "keyed_segment_sum_sorted_f32": _SORTED_ARGS,
    "keyed_segment_sum_i32": _SCATTER_ARGS,
    "keyed_segment_sum_f32": _SCATTER_ARGS,
    "keyed_scatter_add_i64": _SCATTER_ARGS,
    "keyed_scatter_add_i32": _SCATTER_ARGS,
    "keyed_scatter_add_f32": _SCATTER_ARGS,
    # cell key, cell start, row key, row start, row occ, out, n_cells,
    # capacity, max_probes, stream
    "keyed_table_lookup":
        [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    # cell owner, then as above with n_rows before capacity
    "keyed_batched_table_lookup":
        [_P] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [_P],
    # q, k, v, o, lse (or null), B, Hq, Hkv, Sq, Skv, hd, dtype, causal,
    # window, softcap, prefix_len, stream
    "attn_flash_forward":
        [_P] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, _P],
    # q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq, Hkv, Sq, Skv, hd,
    # dtype, causal, window, softcap, prefix_len, stream
    "attn_flash_backward":
        [_P] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, _P],
    # q, k, v, valid_len, o, workspace, counters, B, Hq, Hkv, S, hd, dtype,
    # window, softcap, n_splits, stream
    "attn_decode_forward":
        [_P] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, _P],
    # x, x strides, dt, dt strides, A, Bm, Bm strides, Cm, Cm strides, y,
    # y strides, h, workspace, its bytes, B, H, S, P, N, dtype, stream
    # (strides: int64[3] each)
    "ssd_scan_forward":
        [_P, _STRIDES, _P, _STRIDES, _P, _P, _STRIDES, _P, _STRIDES, _P,
         _STRIDES, _P, _P, ctypes.c_longlong]
        + [ctypes.c_int] * 6 + [_P],
    # x, sx, dt, sdt, A, Bm, sb, Cm, sc, dy, sdy, dh_final (or null), the
    # forward's hprev and decay, dx, sdx, ddt, sddt, dA, dB, dC, g-state,
    # dB / dC / dA partials, B, H, S, P, N, groups, dtype, stream
    "ssd_scan_backward":
        [_P, _STRIDES, _P, _STRIDES, _P, _P, _STRIDES, _P, _STRIDES, _P,
         _STRIDES, _P, _P, _P, _P, _STRIDES, _P, _STRIDES]
        + [_P] * 7 + [ctypes.c_int] * 7 + [_P],
    # x, row_token, out, R, T, row bytes, unit bytes, stream
    "moe_gather_forward":
        [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, _P],
    # dout, table, dx, T, k, R, d, dtype, 16-byte units, stream
    "moe_gather_backward":
        [_P] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
}

_LOCK = threading.Lock()
_LIB: Optional[types.SimpleNamespace] = None
#: the entry points by name, filled when the libraries are loaded
_ENTRIES: dict = {}

#: what the last build did: wall seconds, the compilers' CPU seconds summed
#: over the sources (about what one source after another would take), the
#: sources compiled, the ptxas report of each, and each source's library
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def build(build_dir: Path = BUILD_DIR) -> List[Path]:
    """Compile each ``csrc/*.cu`` into its own shared library, the missing
    ones in parallel; returns the libraries' paths."""
    shared = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for h in sorted(CSRC.glob("*.cuh")):
        shared.update(h.name.encode() + h.read_bytes())
    outs, todo, libraries = [], [], {}
    for src in sorted(CSRC.glob("*.cu")):
        digest = shared.copy()
        digest.update(src.read_bytes())
        out = Path(build_dir) / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"
        outs.append(out)
        libraries[src.name] = out
        if not out.exists():
            todo.append((src, out, out.with_suffix(f".{os.getpid()}.tmp")))
    t0 = time.perf_counter()
    cpu0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    ptxas = {}
    if todo:
        Path(build_dir).mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        cmds = [[nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                for src, _, tmp in todo]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        outputs = [p.communicate() for p in procs]
        for (src, _, _), cmd, p, (out, err) in zip(todo, cmds, procs,
                                                   outputs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}\n{err}")
            ptxas[src.name] = err
        for _, out, tmp in todo:
            os.replace(tmp, out)
    cpu1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0,
        compiler_cpu_seconds=(cpu1.ru_utime + cpu1.ru_stime
                              - cpu0.ru_utime - cpu0.ru_stime),
        compiled=[src.name for src, _, _ in todo], ptxas=ptxas,
        libraries=libraries)
    return outs


def library() -> types.SimpleNamespace:
    """The kernels' C entry points by name (the libraries are built on the
    first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            # PyDLL keeps the GIL through the call (a launch returns within
            # microseconds), which spares ctypes releasing and taking it
            libs = [ctypes.PyDLL(str(p)) for p in build()]
            fns = {}
            for name, args in _SIGNATURES.items():
                fn = next((getattr(lib, name) for lib in libs
                           if hasattr(lib, name)), None)
                if fn is None:
                    raise RuntimeError(f"no kernel library exports {name}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
                fns[name] = fn
            _ENTRIES.update(fns)
            _LIB = types.SimpleNamespace(**fns)
        return _LIB


def check_cuda(names, *tensors, contiguous: bool = True) -> int:
    """All ``tensors`` (called ``names`` in a refusal) on one CUDA device,
    and contiguous unless ``contiguous`` is False (a kernel that reads
    strided views checks their strides itself); returns the device's index.
    The checks read the cheapest tensor properties: the first tensor is on
    CUDA, and every one has its device index (``get_device()``, -1 on the
    CPU; a build has one accelerator)."""
    first = tensors[0]
    dev = first.get_device() if isinstance(first, torch.Tensor) \
        and first.is_cuda else -1
    if dev >= 0:
        for t in tensors:
            if not (isinstance(t, torch.Tensor) and t.get_device() == dev
                    and (not contiguous or t.is_contiguous())):
                break
        else:
            return dev
    where = None
    for name, t in zip(names, tensors):  # the refusal's message
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if where is None:
            where = t.device
        elif t.device != where:
            raise ValueError(f"{name} is on {t.device}, expected {where}")
    raise AssertionError("unreachable")


#: ``current_stream(device)``: the raw ``cudaStream_t`` of the device's
#: current stream, without building a ``torch.cuda.Stream``; and the index
#: of the current device.  PyTorch's own hooks, bound once (a CPU-only build
#: has neither, and never launches)
current_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice", None)


def launch(name: str, device: int, *args) -> None:
    """Call the entry point ``name`` with ``args`` and the current stream of
    CUDA device ``device`` (from :func:`check_cuda`); raise if it returns a
    CUDA error (a launch the card refused)."""
    fn = _ENTRIES.get(name) or getattr(library(), name)
    if device == _current_device():
        rc = fn(*args, current_stream(device))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, current_stream(device))
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
