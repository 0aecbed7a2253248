"""Plain PyTorch versions of the keyed plane's four kernels.

Each function computes what its CUDA kernel computes, on tensors of any
device.  The wrappers take these for CPU tensors; on the card only
``chip_smoke.py``, the GPU tests and ``ops`` mode ``"ref"`` use them.

Integer accumulators: ``segment_sum`` sums integers into int32 with
wraparound (the reference's i32 partials); ``scatter_add`` accumulates in
the table's own dtype (int64 for the window table's columns, int32 wrapping
when held against the reference's i32 kernel).  Ids outside ``[0, n)``
contribute nothing.
"""

from __future__ import annotations

import torch

#: cell x row elements per tile of the plain lookup: its boolean
#: temporaries stay near 1 GB whatever the table size
LOOKUP_TILE_ELEMS = 1 << 28


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (two's complement), explicitly."""
    low = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def _accumulate(out: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor):
    """``out[ids[r]] += rows[r]`` in place for ids in range; int32 outputs
    accumulate in int64 and wrap back."""
    n = out.shape[0]
    ids = ids.to(torch.int64)
    keep = (ids >= 0) & (ids < n)
    ids, rows = ids[keep], rows[keep]
    if out.dtype == torch.int32:
        wide = out.to(torch.int64)
        wide.index_put_((ids,), rows.to(torch.int64), accumulate=True)
        out.copy_(wrap_i32(wide))
    else:
        out.index_put_((ids,), rows.to(out.dtype), accumulate=True)
    return out


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype.is_floating_point:
        return torch.float32
    return torch.int32


def segment_sum_ref(values, seg_ids, num_segments: int) -> torch.Tensor:
    """values ``[R, d]``; seg_ids ``[R]``; returns ``[S, d]`` in int32
    (integers, wrapping) or float32."""
    out = torch.zeros(
        (num_segments, values.shape[1]), dtype=_acc_dtype(values.dtype),
        device=values.device,
    )
    return _accumulate(out, seg_ids, values)


def segment_sum_sorted(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Segment sum for **sorted** ids: prefix sum + gather, no scatter.

    ``P[k]`` is the running total of the first ``k`` rows; each segment is
    the difference of the prefix rows at its end and at the previous
    segment's end (``searchsorted``).  Integers sum in int64 and wrap to
    int32, which gives the same values as the reference's int32 prefix with
    wraparound.  Ids ``>= num_segments`` sort to the tail and drop out.
    PRECONDITION, not checked: unsorted ids give wrong sums."""
    d = values.shape[1]
    acc = _acc_dtype(values.dtype)
    wide = torch.float32 if acc == torch.float32 else torch.int64
    zero = torch.zeros((1, d), dtype=wide, device=values.device)
    prefix = torch.cat([zero, torch.cumsum(values.to(wide), dim=0)])
    ends = torch.searchsorted(
        seg_ids.contiguous(),
        torch.arange(num_segments, dtype=seg_ids.dtype,
                     device=seg_ids.device),
        right=True,
    )
    totals = prefix[ends]
    out = totals - torch.cat([zero, totals[:-1]])
    return wrap_i32(out) if acc == torch.int32 else out


def table_acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator of a scatter-add into a table of ``dtype``: int64 stays
    int64, other integers int32, floats float32."""
    return torch.int64 if dtype == torch.int64 else _acc_dtype(dtype)


def scatter_add_ref(table, ids, rows) -> torch.Tensor:
    """``out = table.clone(); out[ids[r]] += rows[r]`` in the table's own
    accumulator (:func:`table_acc_dtype`)."""
    acc = table_acc_dtype(table.dtype)
    return scatter_add_ref_(table.to(acc).clone(), ids, rows)


def scatter_add_ref_(table, ids, rows) -> torch.Tensor:
    """In-place form of :func:`scatter_add_ref` (the table's dtype)."""
    return _accumulate(table, ids, rows)


def _first_match(m: torch.Tensor, miss: int) -> torch.Tensor:
    first = m.to(torch.uint8).argmax(dim=1)  # first maximal index
    return torch.where(m.any(dim=1), first, miss)


def table_lookup_ref(cell_keys, cell_starts, table_keys, table_starts,
                     table_occ) -> torch.Tensor:
    """Least occupied row whose ``(key, start)`` equals each cell's, over
    the WHOLE table; int32 ``[n]`` with ``capacity`` = miss.  The cell axis
    is tiled so the ``[cells, rows]`` temporaries stay bounded."""
    return batched_table_lookup_ref(
        None, cell_keys, cell_starts, None, table_keys, table_starts,
        table_occ,
    )


def batched_table_lookup_ref(cell_owners, cell_keys, cell_starts,
                             row_owners, table_keys, table_starts,
                             table_occ) -> torch.Tensor:
    """:func:`table_lookup_ref` with an owner plane: a cell matches only
    rows whose owner equals its own; ``n_rows`` = miss."""
    n, total = cell_keys.shape[0], table_keys.shape[0]
    out = torch.full((n,), total, dtype=torch.int32, device=cell_keys.device)
    if not total:
        return out
    occ = table_occ.to(torch.bool)
    tile = max(1, LOOKUP_TILE_ELEMS // max(total, 1))
    for i in range(0, n, tile):
        sl = slice(i, i + tile)
        m = (table_keys[None, :] == cell_keys[sl, None]) \
            & (table_starts[None, :] == cell_starts[sl, None]) & occ[None, :]
        if cell_owners is not None:
            m &= row_owners[None, :] == cell_owners[sl, None]
        out[sl] = _first_match(m, total).to(torch.int32)
    return out
