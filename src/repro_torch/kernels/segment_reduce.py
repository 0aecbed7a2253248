"""Segment sum / scatter-add: wrappers around the CUDA kernels.

Port of ``repro/kernels/segment_reduce.py``.  The TPU pair contracts a
one-hot block against the value rows on the MXU; the CUDA pair
(``csrc/segment_reduce.cu``) is one atomic scatter per element.  Each
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream, raises
if the launch was refused, and counts the launch in :data:`LAUNCHES`.
CPU tensors go to the plain versions in :mod:`repro_torch.kernels.ref`
through :mod:`repro_torch.kernels.ops`, never through these wrappers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_sum_sorted

__all__ = ["LAUNCHES", "scatter_add_", "segment_sum", "segment_sum_sorted"]

#: kernel launches per wrapper (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"segment_sum": 0, "scatter_add": 0}

_SEGMENT_FNS = {
    torch.int32: "keyed_segment_sum_i32",
    torch.float32: "keyed_segment_sum_f32",
}
_SCATTER_FNS = {
    torch.int64: "keyed_scatter_add_i64",
    torch.int32: "keyed_scatter_add_i32",
    torch.float32: "keyed_scatter_add_f32",
}


def check_cuda(**tensors) -> torch.device:
    """All tensors contiguous and on one CUDA device; returns it."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return dev


def _scatter_shapes(rows, ids, n_out: int, what: str):
    if rows.dim() != 2 or ids.dim() != 1 or ids.shape[0] != rows.shape[0]:
        raise ValueError(f"{what}: need rows [R, d] and ids [R], got "
                         f"{tuple(rows.shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{what}: ids must be int32, got {ids.dtype}")
    if n_out >= 2 ** 31 or rows.shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: output of {n_out} rows exceeds int32")


def _launch(name: str, ids, rows, out, n_out: int) -> None:
    fn = getattr(_build.library(), name)
    with torch.cuda.device(out.device):
        rc = fn(ids.data_ptr(), rows.data_ptr(), out.data_ptr(),
                rows.shape[0], rows.shape[1], n_out,
                torch.cuda.current_stream(out.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def segment_sum(values, seg_ids, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[r] over seg_ids[r] == s``: values ``[R, d]``
    int32 or float32, seg_ids ``[R]`` int32 (ids outside ``[0, S)`` drop
    out); returns ``[S, d]`` of the values' dtype.  Order-blind."""
    check_cuda(values=values, seg_ids=seg_ids)
    if values.dtype not in _SEGMENT_FNS:
        raise ValueError(f"segment_sum takes int32/float32, got {values.dtype}")
    _scatter_shapes(values, seg_ids, num_segments, "segment_sum")
    out = torch.zeros((num_segments, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    if values.numel() and num_segments:
        _launch(_SEGMENT_FNS[values.dtype], seg_ids, values, out,
                num_segments)
        LAUNCHES["segment_sum"] += 1
    return out


def scatter_add_(table, ids, rows) -> torch.Tensor:
    """``table[ids[r]] += rows[r]`` IN PLACE, repeats allowed, ids outside
    ``[0, C)`` dropped.  The accumulator is the table's dtype: int64
    (exact, like ``np.add.at``), int32 (wrapping) or float32; ``rows`` must
    have the same dtype.  Returns ``table``."""
    check_cuda(table=table, ids=ids, rows=rows)
    if table.dtype not in _SCATTER_FNS or rows.dtype != table.dtype:
        raise ValueError(
            f"scatter_add takes matching int64/int32/float32 table and rows,"
            f" got {table.dtype} and {rows.dtype}"
        )
    _scatter_shapes(rows, ids, table.shape[0], "scatter_add")
    if table.dim() != 2 or table.shape[1] != rows.shape[1]:
        raise ValueError(f"scatter_add: table {tuple(table.shape)} vs rows "
                         f"{tuple(rows.shape)}")
    if rows.numel() and table.shape[0]:
        _launch(_SCATTER_FNS[table.dtype], ids, rows, table, table.shape[0])
        LAUNCHES["scatter_add"] += 1
    return table
