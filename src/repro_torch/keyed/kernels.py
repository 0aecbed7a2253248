"""Per-chunk cell reduction: the keyed engine's hot path and its baseline.

Port of ``repro/keyed/kernels.py``.  A chunk of keyed window assignments is
reduced to one partial aggregate per **cell** (a distinct ``(key, window)``
pair, numbered ``0..num_cells``).  Two interchangeable implementations:

* ``"segment"`` — the hot path: stable sort by cell, then a segment sum
  through :func:`repro_torch.kernels.ops.segment_sum_sorted` (the CUDA
  kernel for CUDA tensors, the scatter-free prefix-sum realization
  otherwise);
* ``"masked"`` — the S2 masked full-scan baseline, O(num_cells * m): every
  cell inspects every item through a mask.

Both produce bit-identical int32 partials (sums and counts, wrapping modulo
2^32 like the reference's), so the engine's exactness contract is
implementation-independent.  Everything runs on the tensors' own device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import wrap_i32

IMPLS = ("segment", "masked")


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` on tensors: the LAST key is primary; stable, so
    equal rows keep their input order.  One stable sort per key."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def dedup_cells(keys, starts):
    """Canonical duplicate-free cell batch over the ``(key, start)``
    columns.  Returns ``(cells [n, 2] int64, inverse [m] int64)`` with cells
    in lexicographic ``(key, start)`` order — the canonical order every
    table mutator requires.  Because ownership is a function of the key,
    the global canonical order restricted to one shard IS that shard's
    canonical order.  Two stable sorts (start, then key) stand in for the
    reference's ``np.lexsort``; boundary flags mark the new cells."""
    k = keys.to(torch.int64)
    s = starts.to(torch.int64)
    if not len(k):
        return (torch.zeros((0, 2), dtype=torch.int64, device=k.device),
                torch.zeros(0, dtype=torch.int64, device=k.device))
    order = lexsort((s, k))
    ks, ss = k[order], s[order]
    new = torch.ones(len(ks), dtype=torch.bool, device=k.device)
    new[1:] = (ks[1:] != ks[:-1]) | (ss[1:] != ss[:-1])
    inv = torch.empty(len(ks), dtype=torch.int64, device=k.device)
    inv[order] = torch.cumsum(new, 0) - 1
    return torch.stack([ks[new], ss[new]], dim=1), inv


def sort_by_cell(cell_ids, values):
    """Stable sort of (cell_ids, values) by cell id — the 'sort-by-key'
    half of the hot path; stability keeps equal-cell rows in stream
    order."""
    order = torch.argsort(cell_ids, stable=True)
    return cell_ids[order], values[order]


def _masked_path(cell_ids, values, num_cells: int) -> torch.Tensor:
    cells = torch.arange(num_cells, device=cell_ids.device)[:, None]
    mask = cells == cell_ids.to(torch.int64)[None, :]       # [cells, m]
    acc = torch.stack(
        [torch.where(mask, values[:, j].to(torch.int64)[None, :], 0).sum(1)
         for j in range(values.shape[1])],
        dim=1,
    )
    return wrap_i32(acc)


def reduce_by_cell(cell_ids, values, num_cells: int, *,
                   impl: str = "segment") -> torch.Tensor:
    """Per-cell sums of ``values [m, d]`` grouped by ``cell_ids [m]``.

    Returns an int32 ``[num_cells, d]`` tensor on the inputs' device.
    ``impl`` selects the sorted segment-reduce hot path or the masked
    full-scan baseline; both are exact modulo 2^32."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    vals = values.to(torch.int32)
    if num_cells == 0 or cell_ids.shape[0] == 0:
        return torch.zeros((num_cells, values.shape[1]), dtype=torch.int32,
                           device=values.device)
    if impl == "segment":
        ids_sorted, vals_sorted = sort_by_cell(cell_ids.to(torch.int32), vals)
        return ops.segment_sum_sorted(vals_sorted, ids_sorted, num_cells)
    return _masked_path(cell_ids, vals, num_cells)
