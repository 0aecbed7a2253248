"""Segment sum / scatter-add: wrappers around the CUDA kernels.

Port of ``repro/kernels/segment_reduce.py``.  The TPU pair contracts a
one-hot block against the value rows on the MXU; the CUDA kernels
(``csrc/segment_reduce.cu``) are a single-pass reduce-by-key over sorted
ids (:func:`segment_sum_sorted`, the keyed main path's) and a scatter with
one thread per row (:func:`scatter_add_`, and :func:`segment_sum` into a
zeroed output for ids in any order).  Each wrapper takes CUDA tensors
only: it checks device, dtype, shape and contiguity, allocates the output,
launches on the current stream through the shared helpers of
:mod:`repro_torch.kernels._build` (``check_cuda``, ``launch``), raises if
the launch was refused, and counts the launch in :data:`LAUNCHES` (both
segment-sum kernels under ``"segment_sum"``, the TPU kernel they port).
CPU tensors go to the plain versions in :mod:`repro_torch.kernels.ref`
through :mod:`repro_torch.kernels.ops`, never through these wrappers.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._build import check_cuda

__all__ = ["LAUNCHES", "SORTED_TILE", "scatter_add_", "segment_sum",
           "segment_sum_sorted"]

#: kernel launches per wrapper (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"segment_sum": 0, "scatter_add": 0}

#: rows per tile of the sorted kernel (``kSortedTile`` in the source)
SORTED_TILE = 512

_SORTED_FNS = {
    torch.int32: "keyed_segment_sum_sorted_i32",
    torch.float32: "keyed_segment_sum_sorted_f32",
}
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


#: look-back tags are 31 bits: a workspace serves this many tiles, then a
#: zeroed one takes its place
_MAX_TICKETS = 2 ** 31 - 1


class _Workspace:
    """The sorted kernel's tile counter and look-back records on one
    stream: int64 word 0 counts the tiles claimed, then one record word per
    (tile, column), all zeroed once when allocated.  The counter is never
    reset: ``tickets`` is the number of tiles that earlier calls claimed
    from it, which each call passes to the kernel, and a record is tagged
    with its tile's ticket, so the records need no zeroing launch per call.
    Calls on one stream run in order, so one workspace per stream is enough
    (a CUDA graph would freeze ``tickets``: the kernel is not for
    capture)."""

    __slots__ = ("words", "size", "ptr", "tickets")

    def __init__(self, device, size: int):
        self.words = torch.zeros(size, dtype=torch.int64, device=device)
        self.size, self.ptr, self.tickets = size, self.words.data_ptr(), 0


#: one workspace per (device index, raw stream), grown on demand
_WORKSPACES: dict = {}


def _workspace(dev: int, n_tiles: int, d: int) -> _Workspace:
    if dev == _build.META:  # kept across calls: a cost count takes none
        return _Workspace("meta", 0)
    stream = _build.current_stream(dev)
    size = 1 + n_tiles * d
    ws = _WORKSPACES.get((dev, stream))
    if ws is not None and ws.size >= size \
            and ws.tickets + n_tiles <= _MAX_TICKETS:
        return ws
    if ws is not None:
        size = max(size, ws.size if ws.size >= size else 2 * ws.size)
    ws = _WORKSPACES[(dev, stream)] = _Workspace(torch.device("cuda", dev),
                                                 max(size, 1024))
    return ws


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
        _build.count(LAUNCHES, "segment_sum", dev,
                     lambda: costs.segment_sum_cost(n_rows, d, num_segments,
                                                    values.element_size()))
    return out


def segment_sum_sorted(values, seg_ids, num_segments: int) -> torch.Tensor:
    """:func:`segment_sum` for ``seg_ids`` sorted ascending: one launch of
    the reduce-by-key kernel into an uninitialized output, which the kernel
    writes in full (zeros for empty segments).  PRECONDITION, not checked:
    unsorted ids give wrong or unwritten rows.  Float32 sums are
    bit-identical from call to call."""
    dev = check_cuda(("values", "seg_ids"), values, seg_ids)
    fn = _SORTED_FNS.get(values.dtype)
    if fn is None:
        raise ValueError(f"segment_sum_sorted takes int32/float32, got "
                         f"{values.dtype}")
    n_rows, d = _scatter_shapes(values, seg_ids, num_segments,
                                "segment_sum_sorted")
    if n_rows > 2 ** 31 - 2 * SORTED_TILE:
        raise ValueError(f"segment_sum_sorted: {n_rows} rows exceed int32")
    if not (n_rows and d and num_segments):
        return torch.zeros((num_segments, d), dtype=values.dtype,
                           device=values.device)
    out = torch.empty((num_segments, d), dtype=values.dtype,
                      device=values.device)
    n_tiles = -(-n_rows // SORTED_TILE)
    ws = _workspace(dev, n_tiles, d)
    _build.launch(fn, dev, seg_ids.data_ptr(), values.data_ptr(),
                  out.data_ptr(), n_rows, d, num_segments, ws.ptr,
                  ws.tickets)
    ws.tickets += n_tiles
    _build.count(LAUNCHES, "segment_sum", dev,
                 lambda: costs.segment_sum_cost(n_rows, d, num_segments,
                                                values.element_size()))
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
        _build.count(LAUNCHES, "scatter_add", dev,
                     lambda: costs.scatter_add_cost(n_rows, d,
                                                    table.element_size()))
    return table
