"""Dispatch layer: CUDA kernel for CUDA tensors, plain PyTorch for CPU ones.

Port of ``repro/kernels/ops.py`` for the keyed plane's four kernels.
``use_kernels(mode)`` sets the dispatch globally:

* ``"auto"`` (default): a CUDA tensor launches the kernel, a CPU tensor
  takes the plain version;
* ``"kernel"``: the kernel, and a CPU tensor raises;
* ``"ref"``: the plain version on whatever device the tensors live
  (``chip_smoke.py`` and the tests use it to hold the kernels against
  their plain versions on the card).

There is no fallback: a CUDA tensor in ``auto`` mode gets the kernel or an
exception.  The wrappers count their launches (:func:`launch_counts`).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import hash_table as _ht
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_reduce as _sr

MODES = ("auto", "kernel", "ref")
_MODE = "auto"


def use_kernels(mode: str) -> None:
    global _MODE
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _MODE = mode


def kernels_active(device) -> bool:
    """True when tensors on ``device`` dispatch to the CUDA kernels."""
    dev = torch.device(device)
    if _MODE == "ref":
        return False
    if _MODE == "kernel":
        if dev.type != "cuda":
            raise RuntimeError(f"ops mode 'kernel' needs CUDA tensors, got {dev}")
        return True
    return dev.type == "cuda"


def launch_counts() -> Dict[str, int]:
    return {**_sr.LAUNCHES, **_ht.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_sr.LAUNCHES, _ht.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64).contiguous()


def segment_sum(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Per-segment sums (int32 wrapping for integers, float32 for floats),
    order-blind in every mode."""
    if kernels_active(values.device):
        acc = torch.float32 if values.dtype.is_floating_point else torch.int32
        return _sr.segment_sum(values.to(acc).contiguous(), _i32(seg_ids),
                               num_segments)
    return _ref.segment_sum_ref(values, seg_ids, num_segments)


def segment_sum_sorted(values, seg_ids, num_segments: int) -> torch.Tensor:
    """Segment sums for ids already sorted ascending (the keyed layer
    sorts first).  The kernel is order-blind; the plain path exploits the
    sorted layout with the scatter-free prefix-sum realization."""
    if kernels_active(values.device):
        return segment_sum(values, seg_ids, num_segments)
    return _ref.segment_sum_sorted(values, seg_ids, num_segments)


def scatter_add_(table, ids, rows) -> torch.Tensor:
    """``table[ids[r]] += rows[r]`` in place, accumulating in the table's
    dtype (the window table's int64 columns accumulate exactly)."""
    if kernels_active(table.device):
        return _sr.scatter_add_(table, _i32(ids),
                                rows.to(table.dtype).contiguous())
    return _ref.scatter_add_ref_(table, ids, rows)


def scatter_add(table, ids, rows) -> torch.Tensor:
    """Functional form, as the reference's ``scatter_add``: returns the
    updated copy (int64 tables stay int64; other integers accumulate in
    int32, floats in float32)."""
    if kernels_active(table.device):
        acc = _ref.table_acc_dtype(table.dtype)
        return scatter_add_(table.to(acc).clone(), ids, rows)
    return _ref.scatter_add_ref(table, ids, rows)


def table_lookup(cell_keys, cell_starts, table_keys, table_starts,
                 table_occ) -> torch.Tensor:
    """Row index of each ``(key, start)`` cell, int32, ``capacity`` = miss:
    the least matching occupied row over the whole table."""
    args = (_i64(cell_keys), _i64(cell_starts), _i64(table_keys),
            _i64(table_starts), table_occ.to(torch.bool).contiguous())
    if kernels_active(cell_keys.device):
        return _ht.table_lookup(*args)
    return _ref.table_lookup_ref(*args)


def batched_table_lookup(cell_owners, cell_keys, cell_starts, row_owners,
                         table_keys, table_starts,
                         table_occ) -> torch.Tensor:
    """Global row of each ``(owner, key, start)`` cell in the stacked
    all-shard planes, int32, ``n_w * capacity`` = miss."""
    args = (_i32(cell_owners), _i64(cell_keys), _i64(cell_starts),
            _i32(row_owners), _i64(table_keys), _i64(table_starts),
            table_occ.to(torch.bool).contiguous())
    if kernels_active(cell_keys.device):
        return _ht.batched_table_lookup(*args)
    return _ref.batched_table_lookup_ref(*args)
