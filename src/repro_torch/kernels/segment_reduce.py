"""Segment sum / scatter-add: wrappers around the CUDA kernels.

Port of ``repro/kernels/segment_reduce.py``.  The TPU pair contracts a
one-hot block against the value rows on the MXU; the CUDA pair
(``csrc/segment_reduce.cu``) is one atomic scatter per element.  Each
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output, launches on the current stream through
the shared helpers of :mod:`repro_torch.kernels._build` (``check_cuda``,
``launch``), raises if the launch was refused, and counts the launch in
:data:`LAUNCHES`.
CPU tensors go to the plain versions in :mod:`repro_torch.kernels.ref`
through :mod:`repro_torch.kernels.ops`, never through these wrappers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_cuda
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
_SCATTER_NAMES = ("table", "ids", "rows")


def _scatter_shapes(rows, ids, n_out: int, what: str):
    """(R, d) of rows ``[R, d]`` against int32 ids ``[R]``, into an output
    of ``n_out`` rows."""
    shape = rows.shape
    if len(shape) != 2 or ids.shape != shape[:1]:
        raise ValueError(f"{what}: need rows [R, d] and ids [R], got "
                         f"{tuple(shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise ValueError(f"{what}: ids must be int32, got {ids.dtype}")
    if n_out >= 2 ** 31 or shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: output of {n_out} rows exceeds int32")
    return shape


def segment_sum(values, seg_ids, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[r] over seg_ids[r] == s``: values ``[R, d]``
    int32 or float32, seg_ids ``[R]`` int32 (ids outside ``[0, S)`` drop
    out); returns ``[S, d]`` of the values' dtype.  Order-blind."""
    dev = check_cuda(("values", "seg_ids"), values, seg_ids)
    fn = _SEGMENT_FNS.get(values.dtype)
    if fn is None:
        raise ValueError(f"segment_sum takes int32/float32, got {values.dtype}")
    n_rows, d = _scatter_shapes(values, seg_ids, num_segments, "segment_sum")
    out = torch.zeros((num_segments, d), dtype=values.dtype,
                      device=values.device)
    if n_rows and d and num_segments:
        _build.launch(fn, dev, seg_ids.data_ptr(), values.data_ptr(),
                      out.data_ptr(), n_rows, d, num_segments)
        LAUNCHES["segment_sum"] += 1
    return out


def scatter_add_(table, ids, rows) -> torch.Tensor:
    """``table[ids[r]] += rows[r]`` IN PLACE, repeats allowed, ids outside
    ``[0, C)`` dropped.  The accumulator is the table's dtype: int64
    (exact, like ``np.add.at``), int32 (wrapping) or float32; ``rows`` must
    have the same dtype.  Returns ``table``."""
    dev = check_cuda(_SCATTER_NAMES, table, ids, rows)
    fn = _SCATTER_FNS.get(table.dtype)
    if fn is None or rows.dtype != table.dtype:
        raise ValueError(
            f"scatter_add takes matching int64/int32/float32 table and rows,"
            f" got {table.dtype} and {rows.dtype}"
        )
    t_shape = table.shape
    n_rows, d = _scatter_shapes(rows, ids, t_shape[0], "scatter_add")
    if len(t_shape) != 2 or t_shape[1] != d:
        raise ValueError(f"scatter_add: table {tuple(t_shape)} vs rows "
                         f"{tuple(rows.shape)}")
    if n_rows and d and t_shape[0]:
        _build.launch(fn, dev, ids.data_ptr(), rows.data_ptr(),
                      table.data_ptr(), n_rows, d, t_shape[0])
        LAUNCHES["scatter_add"] += 1
    return table
