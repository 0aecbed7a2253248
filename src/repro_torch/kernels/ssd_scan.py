"""Mamba-2 chunked SSD scan: wrapper around the CUDA kernels.

Port of ``repro/kernels/ssd_scan.py``.  The kernels are
``csrc/ssd_scan.cu``, a chunk-parallel scan in three launches: (a) every
chunk's running decay and state contribution, in parallel over (batch,
chunk, heads), with the score tile ``C B^T`` computed once per (batch,
chunk) when B and C are one group shared by every head, else per head;
(b) the states passed from chunk to chunk, elementwise over the state and
serial only in the chunk; (c) every chunk's output from its scores and the
state it receives.  bfloat16 runs its products on the tensor cores in
chunks of :data:`CHUNK` ``[bfloat16]`` positions, float32 on the CUDA cores
in chunks of ``CHUNK[float32]``.  Any sequence length (the tail chunk is
masked), float32 or bfloat16 x / B / C, float32 dt and A, a state size N
that is a multiple of 4 up to 256.

The inputs are taken as strided views in the reference's public layout
(x ``[B, H, S, P]``, dt ``[B, H, S]``, Bm / Cm ``[B, H, S, N]``): the model
passes its ``[B, S, H, P]`` activations transposed and its one shared B/C
group expanded over the heads (head stride 0), and the kernels read them
in place; that head stride 0 is what selects the shared score tile.  Only
the last axis must be contiguous.  y comes back as a ``[B, H, S, P]`` view
of a ``[B, S, H, P]`` buffer, the model's own layout.  The wrapper takes
CUDA tensors only: it checks them, allocates the workspace of
:func:`workspace_bytes` (the chunk states and score tiles), launches on the
current stream through :func:`repro_torch.kernels._build.launch`, raises
on a refused launch and counts one launch per call in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["CHUNK", "LAUNCHES", "MAX_STATE", "shared_group", "ssd_scan",
           "workspace_bytes"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"ssd_scan": 0}
#: the largest state size N the kernels' shared memory takes (N must also
#: be a multiple of 4)
MAX_STATE = 256
#: positions per chunk, by dtype (the kernels' own: csrc/ssd_scan.cu Route)
CHUNK = {torch.float32: 64, torch.bfloat16: 128}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def workspace_bytes(b: int, h: int, s: int, p: int, n: int, dtype,
                    shared: bool) -> int:
    """Bytes of the kernels' workspace: the float32 chunk states ``[b, h,
    nc, n, p]``, the states passed on (as many bytes), the chunk decays
    ``[b, h, nc]`` and the score tiles ``[b, 1 or h, nc, chunk, chunk]``
    (one per chunk for a shared group, else one per head), each 256-byte
    aligned (csrc/ssd_scan.cu ``workspace``)."""
    c = CHUNK[dtype]
    nc = -(-s // c)
    states = b * h * nc * n * p * 4
    decay_at = _align256(_align256(states) + states)
    scores_at = _align256(decay_at + b * h * nc * 4)
    return scores_at + b * (1 if shared else h) * nc * c * c * 4


def shared_group(Bm: torch.Tensor, Cm: torch.Tensor) -> bool:
    """True when B and C are one group read by every head (head stride 0),
    which the kernels take as one score tile per (batch, chunk)."""
    return Bm.stride(1) == 0 and Cm.stride(1) == 0


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
    dev = _build.check_cuda(("x", "dt", "A", "Bm", "Cm"), x, dt, A, Bm, Cm,
                            contiguous=False)
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
    ws = torch.empty(workspace_bytes(b, h, s, p, n, x.dtype,
                                     shared_group(Bm, Cm)),
                     dtype=torch.uint8, device=x.device)
    _build.launch("ssd_scan_forward", dev, x.data_ptr(),
                  _strides("x", x, 4), dt.data_ptr(), _strides("dt", dt, 3),
                  A.data_ptr(), Bm.data_ptr(), _strides("Bm", Bm, 4),
                  Cm.data_ptr(), _strides("Cm", Cm, 4), y.data_ptr(),
                  _strides("y", y, 4), h_out.data_ptr(), ws.data_ptr(),
                  ws.numel(), b, h, s, p, n, DTYPE_CODES[x.dtype])
    LAUNCHES["ssd_scan"] += 1
    return y, h_out
