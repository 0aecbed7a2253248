"""Mamba-2 chunked SSD scan: wrapper around the CUDA kernel.

Port of ``repro/kernels/ssd_scan.py``.  The kernel is ``csrc/ssd_scan.cu``:
one block per (batch, head, 32 columns of the head dim) walks the sequence
in chunks of 64 positions, carrying the float32 state slice in shared
memory.  Any sequence length (the tail chunk is masked), float32 or
bfloat16 x / B / C, float32 dt and A, a state size N that is a multiple of
4 up to 256.

The inputs are taken as strided views in the reference's public layout
(x ``[B, H, S, P]``, dt ``[B, H, S]``, Bm / Cm ``[B, H, S, N]``): the model
passes its ``[B, S, H, P]`` activations transposed and its one shared B/C
group expanded over the heads (head stride 0), and the kernel reads them
in place.  Only the last axis must be contiguous.  y comes back as a
``[B, H, S, P]`` view of a ``[B, S, H, P]`` buffer, the model's own
layout.  The wrapper takes CUDA tensors only: it checks them, launches on
the current stream through :func:`repro_torch.kernels._build.launch`,
raises on a refused launch and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "MAX_STATE", "ssd_scan"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"ssd_scan": 0}
#: the largest state size N the kernel's shared memory takes (N must also
#: be a multiple of 4: the kernel reads B and C rows 16 bytes at a time)
MAX_STATE = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _strides(name: str, t: torch.Tensor, dims: int):
    """(batch, head, seq) strides of a ``dims``-axis tensor whose last axis
    (if it has one beyond seq) is contiguous, as a ctypes int64 triple."""
    if dims == 4 and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"ssd_scan: {name} must be contiguous in its last "
                         f"axis, got strides {t.stride()}")
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def ssd_scan(x, dt, A, Bm, Cm):
    """x ``[B, H, S, P]``; dt ``[B, H, S]`` float32; A ``[H]`` float32;
    Bm, Cm ``[B, H, S, N]`` of x's dtype -> (y ``[B, H, S, P]`` of x's
    dtype, h ``[B, H, N, P]`` float32), from a zero state."""
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, expected "
                             f"{x.device}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: need x [B,H,S,P], dt [B,H,S], A [H], "
                         f"Bm/Cm [B,H,S,N], got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    if tuple(dt.shape) != (b, h, s) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape[:3]) != (b, h, s):
        raise ValueError(f"ssd_scan: shapes do not agree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}")
    if x.dtype not in DTYPE_CODES or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, Bm, Cm must share float32 or "
                         f"bfloat16, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: dt and A must be float32, got "
                         f"{dt.dtype}, {A.dtype}")
    if not 0 < n <= MAX_STATE or n % 4:
        raise ValueError(f"ssd_scan: state size {n} is not a multiple of 4 "
                         f"in [4, {MAX_STATE}]")
    if b > 65535 or h > 65535:
        raise ValueError("ssd_scan: batch and heads must be < 65536")
    A = A.contiguous()
    # y in the model's [B, S, H, P] layout, handed back as a [B, H, S, P] view
    y = torch.empty((b, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    h_out = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, h_out.zero_()
    _build.launch("ssd_scan_forward", x.get_device(), x.data_ptr(),
                  _strides("x", x, 4), dt.data_ptr(), _strides("dt", dt, 3),
                  A.data_ptr(), Bm.data_ptr(), _strides("Bm", Bm, 4),
                  Cm.data_ptr(), _strides("Cm", Cm, 4), y.data_ptr(),
                  _strides("y", y, 4), h_out.data_ptr(), b, h, s, p, n,
                  DTYPE_CODES[x.dtype])
    LAUNCHES["ssd_scan"] += 1
    return y, h_out
