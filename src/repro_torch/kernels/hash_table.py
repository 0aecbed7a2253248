"""Window-table row match: wrappers around the CUDA probe-window lookup.

Port of ``repro/kernels/hash_table.py``.  For each cell, with home ``h =
cell_hash(key, start, capacity)``, the candidate rows are ``owner *
capacity + (h + p) % capacity`` for ``p`` in ``0 .. max_probes - 1``; the
result is the first candidate, in probe order, that is occupied and holds
the cell's key and start, and ``n_rows`` (the rows of the planes) on a miss.
The kernel (``csrc/hash_table.cu``) computes the home itself, 16 lanes per
cell, one probe per lane.

Under the window table's invariant (every live cell has exactly one row,
inside its probe window) this is the row the TPU kernels' full scan
returns, the least matching row of the whole table.  On a table that
breaks the invariant the two differ: a live copy outside the window is not
found, and of two live copies inside it the first in probe order wins.

An owner outside ``[0, n_rows / capacity)`` has no segment, so its cells
miss, as they do in the reference, whose full scan finds no row of that
owner; the wrappers never read the owners on the host, so a lookup waits
for nothing.  The wrappers take CUDA tensors only, check them (whole
segments, ``1 <= max_probes <= capacity``), answer an empty table with
misses without a launch, launch on the current stream through the shared
helpers of :mod:`repro_torch.kernels._build`, raise on a refused launch and
count the launch in :data:`LAUNCHES`.  The plain versions are
:func:`repro_torch.kernels.ref.table_lookup_ref` and
:func:`~repro_torch.kernels.ref.batched_table_lookup_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._build import check_cuda

__all__ = ["LAUNCHES", "batched_table_lookup", "check_lookup",
           "table_lookup"]

#: kernel launches per wrapper (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"table_lookup": 0, "batched_table_lookup": 0}
_LOOKUP_NAMES = ("cell_keys", "cell_starts", "table_keys", "table_starts",
                 "table_occ")
_BATCHED_NAMES = ("cell_owners",) + _LOOKUP_NAMES
_WANT = {"cell_owners": torch.int32, "cell_keys": torch.int64,
         "cell_starts": torch.int64, "table_keys": torch.int64,
         "table_starts": torch.int64, "table_occ": torch.bool}


def check_lookup(n_rows: int, capacity: int, max_probes: int) -> None:
    """Refuse a lookup the function does not define: a table of ``n_rows``
    rows that is not whole segments of ``capacity``, or ``max_probes``
    outside ``[1, capacity]``.  An empty table passes (every cell is a
    miss)."""
    if not n_rows:
        return
    if capacity < 1 or n_rows % capacity or n_rows >= 2 ** 31:
        raise ValueError(f"a table of {n_rows} rows is not int32-indexed "
                         f"segments of capacity {capacity}")
    if not 1 <= max_probes <= capacity:
        raise ValueError(f"max_probes must be in [1, {capacity}], got "
                         f"{max_probes}")


def _check_planes(n: int, total: int, **planes) -> None:
    for name, t in planes.items():
        length = total if name.startswith("table") else n
        if t.dtype != _WANT[name] or t.shape != (length,):
            raise ValueError(f"{name} must be {_WANT[name]} [{length}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _out(n: int, total: int, device) -> torch.Tensor:
    """The result: written whole by the kernel, all misses for an empty
    table (no launch)."""
    if total:
        return torch.empty(n, dtype=torch.int32, device=device)
    return torch.zeros(n, dtype=torch.int32, device=device)


def table_lookup(cell_keys, cell_starts, table_keys, table_starts,
                 table_occ, max_probes: int) -> torch.Tensor:
    """Row of each ``(key, start)`` cell in one table of ``capacity =
    len(table_keys)`` rows, searched over its probe window of
    ``max_probes`` rows; int32 ``[n]`` with ``capacity`` = miss."""
    dev = check_cuda(_LOOKUP_NAMES, cell_keys, cell_starts, table_keys,
                     table_starts, table_occ)
    n, total = cell_keys.shape[0], table_keys.shape[0]
    _check_planes(n, total, cell_keys=cell_keys, cell_starts=cell_starts,
                  table_keys=table_keys, table_starts=table_starts,
                  table_occ=table_occ)
    check_lookup(total, total, max_probes)
    out = _out(n, total, cell_keys.device)
    if n and total:
        _build.launch("keyed_table_lookup", dev, cell_keys.data_ptr(),
                      cell_starts.data_ptr(), table_keys.data_ptr(),
                      table_starts.data_ptr(), table_occ.data_ptr(),
                      out.data_ptr(), n, total, max_probes)
        _build.count(LAUNCHES, "table_lookup", dev,
                     lambda: costs.table_lookup_cost(n, total, max_probes))
    return out


def batched_table_lookup(cell_owners, cell_keys, cell_starts, table_keys,
                         table_starts, table_occ, capacity: int,
                         max_probes: int) -> torch.Tensor:
    """Global row of each ``(owner, key, start)`` cell in the stacked
    ``[n_w * capacity]`` planes: the probe window of ``max_probes`` rows
    inside the owner's segment ``[owner * capacity, (owner + 1) *
    capacity)``; int32 ``[n]`` with ``n_w * capacity`` = miss, also for
    an owner outside ``[0, n_w)``."""
    dev = check_cuda(_BATCHED_NAMES, cell_owners, cell_keys, cell_starts,
                     table_keys, table_starts, table_occ)
    n, total = cell_keys.shape[0], table_keys.shape[0]
    _check_planes(n, total, cell_owners=cell_owners, cell_keys=cell_keys,
                  cell_starts=cell_starts, table_keys=table_keys,
                  table_starts=table_starts, table_occ=table_occ)
    check_lookup(total, capacity, max_probes)
    out = _out(n, total, cell_keys.device)
    if n and total:
        _build.launch("keyed_batched_table_lookup", dev,
                      cell_owners.data_ptr(), cell_keys.data_ptr(),
                      cell_starts.data_ptr(), table_keys.data_ptr(),
                      table_starts.data_ptr(), table_occ.data_ptr(),
                      out.data_ptr(), n, total, capacity, max_probes)
        _build.count(LAUNCHES, "batched_table_lookup", dev,
                     lambda: costs.batched_table_lookup_cost(n, total,
                                                             max_probes))
    return out
