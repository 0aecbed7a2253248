"""MoE token gather: wrapper around the CUDA kernel.

Port of ``repro/kernels/moe_dispatch.py``.  The kernel is
``csrc/moe_dispatch.cu``: one warp per buffer row copies ``x[row_token[r]]``
(or writes zeros for a token outside ``[0, T)``) in 16-byte units where the
row and both base addresses allow it, else in 4- or 2-byte units.  A copy,
so bit-exact for any dtype.  The wrapper takes CUDA tensors only: it checks
them, allocates the output, launches on the current stream through the
shared helpers of :mod:`repro_torch.kernels._build`, raises on a refused
launch and counts the launch in :data:`LAUNCHES`.  The combine has
no kernel (as in the reference): it is
:func:`repro_torch.kernels.ref.moe_combine_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda

__all__ = ["LAUNCHES", "moe_gather"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"moe_gather": 0}


def _unit(row_bytes: int, *ptrs: int) -> int:
    for unit in (16, 4, 2):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    raise ValueError(f"moe_gather: rows of {row_bytes} bytes are not a "
                     f"multiple of 2 bytes")


def moe_gather(x, row_token) -> torch.Tensor:
    """x ``[T, d]``; row_token int32 ``[R]`` -> ``[R, d]`` of x's dtype with
    ``out[r] = x[row_token[r]]``, zeros where the token is outside
    ``[0, T)``."""
    dev = check_cuda(("x", "row_token"), x, row_token)
    if x.dim() != 2 or row_token.dim() != 1:
        raise ValueError(f"moe_gather: need x [T, d] and row_token [R], got "
                         f"{tuple(x.shape)} and {tuple(row_token.shape)}")
    if row_token.dtype != torch.int32:
        raise ValueError(f"moe_gather: row_token must be int32, got "
                         f"{row_token.dtype}")
    t, d = x.shape
    r = row_token.shape[0]
    if t >= 2 ** 31:
        raise ValueError(f"moe_gather: {t} tokens exceed int32")
    out = torch.empty((r, d), dtype=x.dtype, device=x.device)
    if r == 0 or d == 0:
        return out
    row_bytes = d * x.element_size()
    unit = _unit(row_bytes, x.data_ptr(), out.data_ptr())
    _build.launch("moe_gather_forward", dev, x.data_ptr(),
                  row_token.data_ptr(), out.data_ptr(), r, t, row_bytes, unit)
    LAUNCHES["moe_gather"] += 1
    return out
