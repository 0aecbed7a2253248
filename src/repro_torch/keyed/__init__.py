"""repro_torch.keyed — keyed windowed-state subsystem over the §4.2 pattern.

Port of ``repro.keyed``:

* :mod:`repro_torch.keyed.store` — slot-mapped keyed state store (host):
  explicit slot -> owner table, any worker count, minimal-migration
  rebalance, and the session-store relocation planner.
* :mod:`repro_torch.keyed.table` — device-resident window table: dense
  fixed-capacity open-addressed tensors with TTL eviction, the host store
  as spill tier (CUDA lookup and scatter-add kernels).
* :mod:`repro_torch.keyed.windows` — tumbling / sliding / session window
  operators with watermarks and a late-data policy, chunk-exact against the
  reference on either state backend.
* :mod:`repro_torch.keyed.kernels` — the per-chunk cell-reduction hot path:
  sort-by-key + CUDA segment sum, with the masked full-scan baseline.
* :mod:`repro_torch.keyed.runtime` — the sharded state plane under the
  StreamExecutor: live per-worker engine shards, the fused all-shard pass,
  elastic resizes as row-level slot migration between shards.
"""

from repro_torch.keyed.kernels import dedup_cells, reduce_by_cell, sort_by_cell
from repro_torch.keyed.runtime import (
    FUSED_STAGES,
    ITEM_DTYPE,
    KeyedWindowAdapter,
    keyed_stream,
    migrated_rows,
    synthetic_keyed_items,
)
from repro_torch.keyed.store import (
    KeyedStore,
    SlotMap,
    WindowState,
    fold_worker_items,
    hash_to_slot,
    plan_relocation,
)
from repro_torch.keyed.table import (
    BatchedWindowTable,
    DeviceWindowTable,
    TableStats,
    cell_hash,
)
from repro_torch.keyed.windows import KeyedWindowEngine, WindowSpec, expand_panes

__all__ = [
    "FUSED_STAGES",
    "ITEM_DTYPE",
    "BatchedWindowTable",
    "DeviceWindowTable",
    "KeyedStore",
    "KeyedWindowAdapter",
    "KeyedWindowEngine",
    "SlotMap",
    "TableStats",
    "WindowSpec",
    "WindowState",
    "cell_hash",
    "dedup_cells",
    "expand_panes",
    "fold_worker_items",
    "hash_to_slot",
    "keyed_stream",
    "migrated_rows",
    "plan_relocation",
    "reduce_by_cell",
    "sort_by_cell",
    "synthetic_keyed_items",
]
