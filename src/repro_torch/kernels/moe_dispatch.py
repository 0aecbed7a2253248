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

The gather's gradient (training) is :func:`moe_gather_backward`, the
kernel ``gather_rows_backward`` of the same source (one warp per token
summing its at most ``k`` rows in buffer order in float32, rounded once;
counted in ``LAUNCHES["moe_gather_backward"]``), behind
:class:`MoeGatherFunction`.  The token-to-rows table it reads is
:func:`token_rows_table`, a kernel of the same source too (``k + 1``
launches a call, counted as one in ``LAUNCHES["token_rows_table"]``; no
sort, nothing read back to the host), which the model builds once per MoE
layer and hands to both the combine and this Function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._build import check_cuda

__all__ = ["LAUNCHES", "MoeGatherFunction", "moe_gather",
           "moe_gather_backward", "token_rows_table"]

#: kernel launches (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"moe_gather": 0, "moe_gather_backward": 0, "token_rows_table": 0}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    _build.count(LAUNCHES, "moe_gather", dev,
                 lambda: costs.moe_gather_cost(r, d, x.element_size()))
    return out


def token_rows_table(row_token, num_tokens: int,
                     max_rows_per_token: int) -> torch.Tensor:
    """row_token int32 ``[R]`` -> int32 ``[num_tokens, max(k, 1)]``:
    ``table[t, j]`` the buffer index of token ``t``'s ``j``-th row in
    buffer order, ``R`` for none, a token's rows past ``k =
    max_rows_per_token`` dropped, rows of a token outside ``[0,
    num_tokens)`` nowhere.  Bit-identical to ``ref.token_rows_table``
    (int64 there); no sort and no host synchronisation."""
    dev = check_cuda(("row_token",), row_token)
    if row_token.dim() != 1 or row_token.dtype != torch.int32:
        raise ValueError(f"token_rows_table: row_token must be int32 [R], "
                         f"got {row_token.dtype} {tuple(row_token.shape)}")
    r, k = row_token.shape[0], max(max_rows_per_token, 1)
    if r >= 2 ** 31 or num_tokens * k >= 2 ** 38:
        raise ValueError("token_rows_table: rows and the table must fit the "
                         "kernel's int32 indices")
    table = torch.empty((num_tokens, k), dtype=torch.int32,
                        device=row_token.device)
    if num_tokens:
        _build.launch("moe_token_table", dev, row_token.data_ptr(),
                      table.data_ptr(), r, num_tokens, k)
        _build.count(LAUNCHES, "token_rows_table", dev,
                     lambda: costs.token_rows_table_cost(r, num_tokens, k))
    return table


def moe_gather_backward(dout, row_token, num_tokens: int, *,
                        max_rows_per_token: int,
                        table=None) -> torch.Tensor:
    """The gradient of :func:`moe_gather` for its output's gradient
    ``dout`` ``[R, d]`` (float32 or bfloat16): ``dx[t] = sum_{r:
    row_token[r] == t} dout[r]`` for ``t < num_tokens``, each token's at
    most ``max_rows_per_token`` rows in buffer order, summed in float32 and
    rounded once -> ``[num_tokens, d]`` of dout's dtype; rows of other
    tokens (the dummy) give nothing.  ``table``: the int32
    :func:`token_rows_table` of these rows, built here when None.
    Bit-exact against ``ref.moe_gather_backward_ref``."""
    dev = check_cuda(("dout", "row_token"), dout, row_token)
    if dout.dim() != 2 or row_token.dim() != 1 \
            or row_token.shape[0] != dout.shape[0]:
        raise ValueError(f"moe_gather_backward: need dout [R, d] and "
                         f"row_token [R], got {tuple(dout.shape)} and "
                         f"{tuple(row_token.shape)}")
    if dout.dtype not in DTYPE_CODES:
        raise ValueError(f"moe_gather_backward: dout must be float32 or "
                         f"bfloat16, got {dout.dtype}")
    r, d = dout.shape
    if num_tokens >= 2 ** 31 or r >= 2 ** 31:
        raise ValueError("moe_gather_backward: tokens and rows must fit "
                         "int32")
    dx = torch.empty((num_tokens, d), dtype=dout.dtype, device=dout.device)
    if num_tokens == 0 or d == 0:
        return dx
    if table is None:
        table = token_rows_table(row_token, num_tokens, max_rows_per_token)
    elif table.dtype != torch.int32 or table.shape != (
            num_tokens, max(max_rows_per_token, 1)) \
            or not table.is_contiguous() or table.device != dout.device:
        raise ValueError(f"moe_gather_backward: table must be contiguous "
                         f"int32 [{num_tokens}, "
                         f"{max(max_rows_per_token, 1)}] on {dout.device}")
    vec = (d * dout.element_size()) % 16 == 0 and dout.data_ptr() % 16 == 0 \
        and dx.data_ptr() % 16 == 0
    _build.launch("moe_gather_backward", dev, dout.data_ptr(),
                  table.data_ptr(), dx.data_ptr(), num_tokens,
                  table.shape[1], r, d, DTYPE_CODES[dout.dtype], int(vec))
    _build.count(LAUNCHES, "moe_gather_backward", dev,
                 lambda: costs.moe_gather_backward_cost(
                     num_tokens, r, d, table.shape[1], dout.element_size()))
    return dx


class MoeGatherFunction(torch.autograd.Function):
    """:func:`moe_gather` with its gradient from :func:`moe_gather_backward`
    (CUDA tensors, and ``meta`` ones in a cost count), or ``ref.moe_gather_ref`` with
    ``ref.moe_gather_backward_ref`` (CPU tensors).  ``apply(x, row_token,
    max_rows_per_token, table=None)``; x contiguous, row_token int32;
    ``table`` the rows' :func:`token_rows_table`, which the backward reads
    (on CUDA tensors it builds one when None)."""

    @staticmethod
    def forward(ctx, x, row_token, max_rows_per_token, table=None):
        from repro_torch.kernels import ref

        ctx.save_for_backward(row_token, table)
        ctx.num_tokens, ctx.bound = x.shape[0], max_rows_per_token
        if not x.is_cpu:
            return moe_gather(x, row_token)
        return ref.moe_gather_ref(x, row_token)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import ref

        row_token, table = ctx.saved_tensors
        if not dout.is_cpu:
            dx = moe_gather_backward(dout.contiguous(), row_token,
                                     ctx.num_tokens,
                                     max_rows_per_token=ctx.bound,
                                     table=table)
        else:
            dx = ref.moe_gather_backward_ref(dout, row_token, ctx.num_tokens,
                                             max_rows_per_token=ctx.bound,
                                             table=table)
        return dx, None, None, None
