"""Window-table row match: wrappers around the CUDA lookup kernel.

Port of ``repro/kernels/hash_table.py``.  Both functions return, for each
cell, the least occupied row of the whole table whose planes equal the
cell's (``n_rows`` on a miss) -- the TPU kernels' function, with int64
keys compared directly instead of as int32 lo/hi halves.  The kernel is
``csrc/hash_table.cu``; the wrappers take CUDA tensors only, check them,
launch on the current stream, raise on a refused launch and count the
launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import check_cuda

__all__ = ["LAUNCHES", "batched_table_lookup", "table_lookup"]

#: kernel launches per wrapper (reset with ``ops.reset_launch_counts``)
LAUNCHES = {"table_lookup": 0, "batched_table_lookup": 0}


def _check_planes(n: int, total: int, **planes) -> None:
    want = {
        "cell_owners": (torch.int32, n), "cell_keys": (torch.int64, n),
        "cell_starts": (torch.int64, n), "row_owners": (torch.int32, total),
        "table_keys": (torch.int64, total),
        "table_starts": (torch.int64, total),
        "table_occ": (torch.bool, total),
    }
    for name, t in planes.items():
        dtype, length = want[name]
        if t.dtype != dtype or t.shape != (length,):
            raise ValueError(f"{name} must be {dtype} [{length}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if total >= 2 ** 31:
        raise ValueError(f"table of {total} rows exceeds the int32 output")


def _launch(name: str, args, n: int, total: int, dev) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        fn = getattr(_build.library(), name)
        with torch.cuda.device(dev):
            rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), n, total,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        LAUNCHES[name.removeprefix("keyed_")] += 1
    return out


def table_lookup(cell_keys, cell_starts, table_keys, table_starts,
                 table_occ) -> torch.Tensor:
    """Row of each ``(key, start)`` cell in one table; int32 ``[n]`` with
    ``capacity`` = miss."""
    dev = check_cuda(cell_keys=cell_keys, cell_starts=cell_starts,
                     table_keys=table_keys, table_starts=table_starts,
                     table_occ=table_occ)
    n, total = cell_keys.shape[0], table_keys.shape[0]
    _check_planes(n, total, cell_keys=cell_keys, cell_starts=cell_starts,
                  table_keys=table_keys, table_starts=table_starts,
                  table_occ=table_occ)
    return _launch(
        "keyed_table_lookup",
        (cell_keys, cell_starts, table_keys, table_starts, table_occ),
        n, total, dev,
    )


def batched_table_lookup(cell_owners, cell_keys, cell_starts, row_owners,
                         table_keys, table_starts,
                         table_occ) -> torch.Tensor:
    """Global row of each ``(owner, key, start)`` cell in the stacked
    ``[n_w * capacity]`` planes; int32 ``[n]`` with ``n_w * capacity`` =
    miss.  A cell matches only rows of its own owner."""
    dev = check_cuda(cell_owners=cell_owners, cell_keys=cell_keys,
                     cell_starts=cell_starts, row_owners=row_owners,
                     table_keys=table_keys, table_starts=table_starts,
                     table_occ=table_occ)
    n, total = cell_keys.shape[0], table_keys.shape[0]
    _check_planes(n, total, cell_owners=cell_owners, cell_keys=cell_keys,
                  cell_starts=cell_starts, row_owners=row_owners,
                  table_keys=table_keys, table_starts=table_starts,
                  table_occ=table_occ)
    return _launch(
        "keyed_batched_table_lookup",
        (cell_owners, cell_keys, cell_starts, row_owners, table_keys,
         table_starts, table_occ),
        n, total, dev,
    )
