"""Device-resident keyed window table: dense tensors, open addressing, TTL.

Port of ``repro/keyed/table.py``.  The reference keeps its slabs as host
numpy arrays and copies them into every kernel call; here every plane is a
torch tensor on the table's device and stays there between chunks.  Only
what leaves the plane (spill, due rows, evictions, snapshots) is copied to
the host, by the engine.

Layout and addressing
    A **row** holds one open cell (a distinct ``(key, window_start)`` pair).
    Rows are addressed by open addressing: a cell's home slot is
    ``cell_hash(key, start) % capacity`` and an insert probes the window
    ``home .. home + max_probes`` (mod capacity) for a match or an empty
    row.  **Lookup scans the whole probe window** (it does not stop at the
    first empty row), so freeing rows needs no tombstones and a live cell
    always has exactly one row — the invariant under which the CUDA
    full-scan lookup kernel and the probe-window realization agree.

Planes
    ``key``, ``start``, ``end``, ``touch`` are int64 ``[capacity]``; the
    ``value`` and ``count`` columns are the two columns of one int64
    ``vc [capacity, 2]`` plane, so one ``scatter_add`` launch accumulates
    both; ``occ`` is bool.  Per row that is the reference's 49 bytes, so
    ``copied_bytes`` counts the same bytes.

Tiering (spill + TTL eviction)
    The host :class:`~repro_torch.keyed.store.KeyedStore` stays on as the
    spill tier: a cell that cannot be placed within its probe window is
    returned to the caller, and a row idle past ``ttl`` watermark units
    (``last_touch + ttl <= watermark``) is evicted to the same tier.  Tier
    placement is never semantic.

Realizations
    When the kernels are active (CUDA tensors, ops mode ``auto`` or
    ``kernel``) lookup is the CUDA full-scan match kernel and the
    accumulate is the CUDA ``scatter_add`` kernel, in int64.  Otherwise
    lookup is the probe-window gather-and-compare and the accumulate is the
    plain ``scatter_add``.  All paths produce bit-identical tables.  The
    reference's accumulate is int64 ``np.add.at`` (its docstrings name the
    i32 ``scatter_add`` kernel, which its code does not call); the port
    runs the kernel in int64, which equals ``np.add.at``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.keyed.kernels import lexsort
from repro_torch.keyed.store import HASH_MULTIPLIER, hash_to_slot, u64_mod

#: second mix constant (64-bit golden ratio) — decorrelates the window start
#: from the key before the multiplicative hash spreads the cell over rows
_START_MIX = np.uint64(0x9E3779B97F4A7C15)
_START_MIX_I64 = int(_START_MIX) - 2 ** 64  # the same bits as int64

#: last-touch sentinel for a just-claimed row: far enough below any event
#: time that the first ``max(touch, ts)`` always wins, far enough above
#: INT64_MIN that ``touch + ttl`` never wraps
_NEVER_TOUCHED = -(2 ** 62)

I64 = torch.int64


def cell_hash(keys, starts, capacity: int):
    """Home row of each ``(key, window_start)`` cell in ``[0, capacity)``.

    uint64 wraparound arithmetic end to end (negative keys wrap exactly like
    :func:`~repro_torch.keyed.store.hash_to_slot`).  numpy inputs are hashed
    as the reference does; tensors are hashed on their device with int64
    products that wrap modulo 2^64 and an unsigned remainder
    (:func:`~repro_torch.keyed.store.u64_mod`), giving the same rows."""
    if isinstance(keys, torch.Tensor):
        k = keys.to(I64)
        s = torch.as_tensor(starts, dtype=I64, device=k.device)
        mix = k * HASH_MULTIPLIER + s * _START_MIX_I64
        return u64_mod(mix * HASH_MULTIPLIER, capacity)
    k = np.asarray(keys, np.int64).astype(np.uint64)
    s = np.asarray(starts, np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        mix = k * np.uint64(HASH_MULTIPLIER) + s * _START_MIX
        return (
            (mix * np.uint64(HASH_MULTIPLIER)) % np.uint64(capacity)
        ).astype(np.int64)


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I64, device=device)


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Column of the first True of each row (0 for an all-False row)."""
    return m.to(torch.uint8).argmax(dim=1)


def _claim_rows(
    key, start, end, value, count, touch, occ, cand, ck, cs, ce, stats,
) -> torch.Tensor:
    """The open-addressing claim loop shared by the per-shard table and the
    batched all-shard plane (the caller supplies the candidate-row matrix
    ``cand`` and the column tensors, slab or flattened-plane views).

    Deterministic conflict rule: when several cells want the same empty row
    in the same round, the first cell in canonical order wins; losers move
    on to their next in-window empty row in the next round.  The reference
    picks the winners with ``np.unique(return_index=True)``; here a stable
    sort of the wanted rows plus group-first does the same on the device.
    """
    n = len(ck)
    rows = torch.full((n,), -1, dtype=I64, device=ck.device)
    if not n:
        return rows
    active = torch.arange(n, device=ck.device)
    while len(active):
        free = ~occ[cand[active]]                        # [a, P]
        has_free = free.any(dim=1)
        n_spill = int((~has_free).sum())
        if n_spill:
            stats.spilled += n_spill
            active = active[has_free]
            free = free[has_free]
        if not len(active):
            break
        want = cand[active, _first_true(free)]
        # first claimant (canonical cell order) per row wins this round
        sorted_want, order = torch.sort(want, stable=True)
        lead = torch.ones(len(want), dtype=torch.bool, device=ck.device)
        lead[1:] = sorted_want[1:] != sorted_want[:-1]
        winner_pos = order[lead]
        winners = active[winner_pos]
        w_rows = sorted_want[lead]
        rows[winners] = w_rows
        occ[w_rows] = True
        key[w_rows] = ck[winners]
        start[w_rows] = cs[winners]
        end[w_rows] = ce[winners]
        value[w_rows] = 0
        count[w_rows] = 0
        touch[w_rows] = _NEVER_TOUCHED
        stats.inserted += len(winners)
        keep = torch.ones(len(active), dtype=torch.bool, device=ck.device)
        keep[winner_pos] = False
        active = active[keep]
    return rows


def _probe_distance_stats(d: np.ndarray) -> Tuple[float, int]:
    return (float(d.mean()) if len(d) else 0.0,
            int(d.max()) if len(d) else 0)


@dataclasses.dataclass
class TableStats:
    """Placement accounting (not part of window semantics)."""

    inserted: int = 0   # cells that claimed a fresh row
    hits: int = 0       # cells that accumulated into an existing row
    spilled: int = 0    # cells handed to the host tier (probe window full)
    evicted: int = 0    # rows moved to the host tier by TTL


class DeviceWindowTable:
    """Fixed-capacity open-addressed table of open ``(key, window)`` cells.

    ``capacity`` rows; each row is ``(key, start, end, value, count,
    last_touch)`` plus an occupancy bit, all on ``device``.  All mutators
    take **canonically sorted, duplicate-free** cell batches — that is what
    makes claim conflicts deterministic.  Inputs may be numpy arrays or
    tensors; outputs are tensors on the table's device.
    """

    COLUMNS = ("key", "start", "end", "value", "count", "touch")

    def __init__(self, capacity: int, *, max_probes: int = 16, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_probes < 1:
            raise ValueError(f"max_probes must be >= 1, got {max_probes}")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.max_probes = min(max_probes, capacity)

        def plane():
            return torch.zeros(capacity, dtype=I64, device=self.device)

        self.key, self.start, self.end = plane(), plane(), plane()
        self.vc = torch.zeros((capacity, 2), dtype=I64, device=self.device)
        self.value, self.count = self.vc[:, 0], self.vc[:, 1]
        self.touch = plane()
        self.occ = torch.zeros(capacity, dtype=torch.bool, device=self.device)
        self.stats = TableStats()

    # -- introspection ---------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return int(self.occ.sum())

    @property
    def load_factor(self) -> float:
        return self.occupancy / self.capacity

    def rows(self) -> torch.Tensor:
        """Occupied rows as an ``[n, 6]`` int64 tensor in row-index order
        (columns per :attr:`COLUMNS`) — placement order, NOT canonical."""
        idx = torch.nonzero(self.occ).flatten()
        return torch.stack(
            [self.key[idx], self.start[idx], self.end[idx],
             self.value[idx], self.count[idx], self.touch[idx]],
            dim=1,
        )

    def probe_distances(self) -> torch.Tensor:
        """Displacement of every occupied row from its cell's home slot
        (``(row - home) % capacity``) — the clustering signal the health
        gauges summarize."""
        idx = torch.nonzero(self.occ).flatten()
        home = cell_hash(self.key[idx], self.start[idx], self.capacity)
        return torch.remainder(idx - home, self.capacity)

    def health(self) -> dict:
        """Flat health snapshot: occupancy/load plus probe-distance stats
        (zeros on an empty table), the statistics taken on the host with
        numpy as the reference takes them."""
        mean, mx = _probe_distance_stats(self.probe_distances().cpu().numpy())
        return {
            "capacity": self.capacity,
            "occupancy": self.occupancy,
            "load_factor": self.load_factor,
            "probe_mean": mean,
            "probe_max": mx,
        }

    # -- probe-window lookup ---------------------------------------------------
    def _probe_window(self, h: torch.Tensor) -> torch.Tensor:
        """``[n, P]`` candidate rows for home slots ``h`` (wrapping)."""
        p = torch.arange(self.max_probes, dtype=I64, device=self.device)
        return torch.remainder(h[:, None] + p, self.capacity)

    def lookup(self, cell_keys, cell_starts) -> torch.Tensor:
        """Row of each cell, or ``-1`` for absent cells.

        The CUDA full-scan match kernel when the kernels are active, the
        probe-window gather-and-compare otherwise; both return the identical
        (unique) row."""
        ck = _i64(cell_keys, self.device)
        cs = _i64(cell_starts, self.device)
        if not len(ck):
            return torch.zeros(0, dtype=I64, device=self.device)
        if ops.kernels_active(self.device):
            rows = ops.table_lookup(ck, cs, self.key, self.start,
                                    self.occ).to(I64)
            return torch.where(rows >= self.capacity, -1, rows)
        cand = self._probe_window(cell_hash(ck, cs, self.capacity))
        m = (
            self.occ[cand]
            & (self.key[cand] == ck[:, None])
            & (self.start[cand] == cs[:, None])
        )
        rows = cand.gather(1, _first_true(m)[:, None])[:, 0]
        return torch.where(m.any(dim=1), rows, -1)

    # -- open-addressing claim -------------------------------------------------
    def _claim(self, ck, cs, ce) -> torch.Tensor:
        """Claim a row for each (absent) cell; ``-1`` = spill."""
        return _claim_rows(
            self.key, self.start, self.end, self.value, self.count,
            self.touch, self.occ,
            self._probe_window(cell_hash(ck, cs, self.capacity)),
            ck, cs, ce, self.stats,
        )

    # -- the per-chunk fused update --------------------------------------------
    def update(
        self, cell_keys, cell_starts, cell_ends, value_sums, counts,
        touch_ts: int,
    ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Accumulate per-cell partials into the table; returns the spill.

        Cells must be canonically sorted and duplicate-free.  Existing rows
        accumulate (``value += sum``, ``count += n``, ``touch = max(touch,
        touch_ts)``); absent cells claim rows via open addressing; cells
        that cannot be placed are returned as ``(key, start, end, value,
        count)`` tensors for the caller's host tier (``None`` when nothing
        spilled)."""
        d = self.device
        ck, cs, ce = _i64(cell_keys, d), _i64(cell_starts, d), _i64(cell_ends, d)
        vs, cn = _i64(value_sums, d), _i64(counts, d)
        if not len(ck):
            return None
        rows = self.lookup(ck, cs)
        miss = rows < 0
        n_miss = int(miss.sum())
        self.stats.hits += len(ck) - n_miss
        if n_miss:
            rows[miss] = self._claim(ck[miss], cs[miss], ce[miss])
        ok = rows >= 0
        r = rows[ok]
        # rows of distinct cells are distinct: the touch max needs no scatter
        ops.scatter_add_(self.vc, r, torch.stack([vs[ok], cn[ok]], dim=1))
        self.touch[r] = torch.clamp_min(self.touch[r], int(touch_ts))
        if len(r) == len(ck):
            return None
        sp = ~ok
        return ck[sp], cs[sp], ce[sp], vs[sp], cn[sp]

    # -- watermark close / TTL eviction ----------------------------------------
    def _extract(self, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        idx = torch.nonzero(mask).flatten()
        out = (
            self.key[idx], self.start[idx], self.end[idx], self.value[idx],
            self.count[idx], self.touch[idx],
        )
        self.occ[idx] = False
        return out

    def take_due(self, watermark: int) -> Tuple[torch.Tensor, ...]:
        """Remove and return every row with ``end <= watermark`` as
        ``(key, start, end, value, count, touch)`` in row-index order."""
        return self._extract(self.occ & (self.end <= watermark))

    def evict_idle(self, watermark: int, ttl: int) -> Tuple[torch.Tensor, ...]:
        """Remove and return rows idle past ``ttl`` watermark units
        (``touch + ttl <= watermark``) — the TTL spill to the host tier."""
        out = self._extract(self.occ & (self.touch + ttl <= watermark))
        self.stats.evicted += len(out[0])
        return out

    def clear(self) -> None:
        self.occ[:] = False

    # -- canonical round-trip --------------------------------------------------
    def insert_rows(
        self, keys, starts, ends, values, counts, touches,
    ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Bulk-place fully-formed rows (restore / migration).  Rows must
        be canonically sorted; placement is by the same claim rule as live
        inserts.  Rows that do not fit are returned (the :meth:`update`
        spill layout plus the touch column) for the host tier."""
        d = self.device
        ck = _i64(keys, d)
        if not len(ck):
            return None
        cs, ce = _i64(starts, d), _i64(ends, d)
        vs, cn, tc = _i64(values, d), _i64(counts, d), _i64(touches, d)
        rows = self._claim(ck, cs, ce)
        ok = rows >= 0
        r = rows[ok]
        self.value[r] = vs[ok]
        self.count[r] = cn[ok]
        self.touch[r] = tc[ok]
        if len(r) == len(ck):
            return None
        sp = ~ok
        return ck[sp], cs[sp], ce[sp], vs[sp], cn[sp], tc[sp]

    # -- §4.2 ownership over rows ----------------------------------------------
    def extract_slot_rows(
        self, slots, num_slots: int
    ) -> Tuple[torch.Tensor, ...]:
        """Remove and return every occupied row whose key hashes to a slot
        in ``slots``, in canonical ``(key, start, end)`` order (the layout
        of :meth:`take_due`) — the device tier's half of a slot migration."""
        idx = torch.nonzero(self.occ).flatten()
        row_slots = hash_to_slot(self.key[idx], num_slots)
        mask = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        mask[idx[torch.isin(row_slots, _i64(slots, self.device))]] = True
        out = self._extract(mask)
        order = lexsort((out[2], out[1], out[0]))
        return tuple(col[order] for col in out)

    def owners(self, slot_table, num_slots: int) -> torch.Tensor:
        """Owner worker of every occupied row (row keys hashed through the
        engine's slot map)."""
        idx = torch.nonzero(self.occ).flatten()
        slots = hash_to_slot(self.key[idx], num_slots)
        return _i64(slot_table, self.device)[slots]


# ---------------------------------------------------------------------------
# batched all-shard plane
# ---------------------------------------------------------------------------

class BatchedWindowTable:
    """Shard-major stack of ``n_w`` per-shard tables: one ``(n_w, capacity)``
    plane per column, driven by whole-chunk batched mutators.

    Construction **adopts** the shards' slabs: each column is stacked into
    one plane and every shard's :class:`DeviceWindowTable` is re-pointed at
    its row of the stack, so the per-shard tables become *views* — per-shard
    mutators (the ``fused=False`` loop, row-level slot migration) and the
    batched whole-plane mutators see the same device storage.

    Addressing: a cell owned by shard ``w`` lives only in global rows
    ``[w * capacity, (w + 1) * capacity)`` and its probe window wraps
    *within* the segment, so claim conflicts are intra-shard and batched
    claims place every row exactly where the per-shard loop would.

    Placement stats accumulate on shard 0's :class:`TableStats`; the
    barrier sums per-shard counters.

    Incremental restack
        The planes are **over-allocated**: storage holds ``alloc >=
        n_shards`` segments and the public planes are active-prefix *views*
        of the first ``n_shards``.  :meth:`restack` re-slices the prefix
        (shrink), clears occupancy of fresh segments in place (grow within
        ``alloc``), and copies only when the allocation itself must grow —
        ``copied_bytes`` counts exactly those bytes.
    """

    _PLANES = ("key", "start", "end", "vc", "touch", "occ")

    def __init__(self, tables: List[DeviceWindowTable], *, reserve: int = 0):
        if not tables:
            raise ValueError("need at least one shard table")
        cap = tables[0].capacity
        if any(t.capacity != cap or t.max_probes != tables[0].max_probes
               for t in tables):
            raise ValueError("shard tables must agree on capacity/max_probes")
        self.device = tables[0].device
        if any(t.device != self.device for t in tables):
            raise ValueError("shard tables must live on one device")
        self.capacity = cap
        self.max_probes = tables[0].max_probes
        #: bytes copied by restacks (plane realloc / foreign-slab adopt);
        #: stays 0 across resizes that fit the allocation
        self.copied_bytes = 0
        self._alloc = max(len(tables), reserve, 1)
        for name in self._PLANES:
            src = getattr(tables[0], name)
            setattr(self, f"_a{name}", torch.zeros(
                (self._alloc, *src.shape), dtype=src.dtype, device=self.device
            ))
        self._arow_owner = self._owner_plane(self._alloc)
        for w, t in enumerate(tables):
            for name in self._PLANES:
                getattr(self, f"_a{name}")[w] = getattr(t, name)
        self.n_shards = len(tables)
        self._activate()
        self._adopt(tables)

    def _owner_plane(self, alloc: int) -> torch.Tensor:
        return torch.arange(alloc, dtype=torch.int32, device=self.device) \
            .repeat_interleave(self.capacity)

    def _activate(self) -> None:
        """Re-derive the active-prefix views from the backing planes:
        ``(n_shards, capacity)`` per column, their flat aliases (global row
        = ``w*cap + row``), and the row-owner column — views, never
        copies."""
        n = self.n_shards
        for name in self._PLANES:
            plane = getattr(self, f"_a{name}")[:n]
            setattr(self, name, plane)
            flat = plane.reshape(-1, 2) if name == "vc" else plane.reshape(-1)
            setattr(self, f"_f{name}", flat)
        self.value, self.count = self.vc[..., 0], self.vc[..., 1]
        self._fvalue, self._fcount = self._fvc[:, 0], self._fvc[:, 1]
        #: shard id of every global row — the kernel's owner plane
        self.row_owner = self._arow_owner[: n * self.capacity]

    def _adopt(self, tables: List[DeviceWindowTable]) -> None:
        """Re-point every shard table at its segment of the planes (the
        tables become views) and remember the adopted objects so a later
        :meth:`restack` can recognize unmoved segments by identity."""
        for w, t in enumerate(tables):
            t.key, t.start, t.end = self.key[w], self.start[w], self.end[w]
            t.vc = self.vc[w]
            t.value, t.count = t.vc[:, 0], t.vc[:, 1]
            t.touch, t.occ = self.touch[w], self.occ[w]
        self._adopted: List[DeviceWindowTable] = list(tables)
        self.stats = tables[0].stats

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def _realloc(self, alloc2: int) -> None:
        """Grow the backing planes; the ONLY place a survivor segment is
        ever copied, and every byte is charged to ``copied_bytes``."""
        n = self.n_shards
        for name in self._PLANES:
            old = getattr(self, f"_a{name}")
            new = torch.zeros((alloc2, *old.shape[1:]), dtype=old.dtype,
                              device=self.device)
            new[:n] = old[:n]
            self.copied_bytes += self._nbytes(old[:n])
            setattr(self, f"_a{name}", new)
        self._arow_owner = self._owner_plane(alloc2)
        self._alloc = alloc2

    def restack(self, tables: List[DeviceWindowTable]) -> None:
        """Re-form the plane for a resized shard list WITHOUT a full
        restack: survivors (recognized by identity) are untouched; a shrink
        is a prefix re-slice; a grow adopts fresh empty segments by clearing
        occupancy in place.  Slab bytes move only on an allocation growth
        (``copied_bytes``)."""
        if any(t.capacity != self.capacity or t.max_probes != self.max_probes
               for t in tables):
            raise ValueError("shard tables must agree on capacity/max_probes")
        if len(tables) > self._alloc:
            self._realloc(max(len(tables), 2 * self._alloc))
        prior = self._adopted
        for w, t in enumerate(tables):
            if w < len(prior) and t is prior[w]:
                continue  # survivor: its segment never moves
            if bool(t.occ.any()):
                # foreign non-empty table (restore path): copy its slab in
                for name in self._PLANES:
                    getattr(self, f"_a{name}")[w] = getattr(t, name)
                    self.copied_bytes += self._nbytes(getattr(t, name))
            else:
                # fresh shard joining a grow: an empty segment is just a
                # cleared occupancy row — zero column traffic
                self._aocc[w] = False
        self.n_shards = len(tables)
        self._activate()
        self._adopt(tables)

    @property
    def total_rows(self) -> int:
        return self.n_shards * self.capacity

    def plane_bytes(self) -> Tuple[int, int]:
        """``(active, allocated)`` bytes of the device planes, row-owner
        plane included."""
        per_seg = sum(self._nbytes(getattr(self, f"_a{n}")[0])
                      for n in self._PLANES) + 4 * self.capacity
        return self.n_shards * per_seg, self._alloc * per_seg

    def _probe_window(self, owners: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
        """``[n, P]`` global candidate rows: the per-shard probe window
        offset into each owner's segment (never crosses a shard boundary)."""
        p = torch.arange(self.max_probes, dtype=I64, device=self.device)
        probes = torch.remainder(h[:, None] + p, self.capacity)
        return owners[:, None] * self.capacity + probes

    # -- batched lookup --------------------------------------------------------
    def lookup(self, owners, cell_keys, cell_starts) -> torch.Tensor:
        """Global row of each ``(owner, key, start)`` cell, ``-1`` = absent:
        one CUDA batched-lookup launch for ALL shards when the kernels are
        active, the probe-window realization otherwise."""
        d = self.device
        ck, cs, ow = _i64(cell_keys, d), _i64(cell_starts, d), _i64(owners, d)
        if not len(ck):
            return torch.zeros(0, dtype=I64, device=d)
        if ops.kernels_active(d):
            rows = ops.batched_table_lookup(
                ow, ck, cs, self.row_owner, self._fkey, self._fstart,
                self._focc,
            ).to(I64)
            return torch.where(rows >= self.total_rows, -1, rows)
        cand = self._probe_window(ow, cell_hash(ck, cs, self.capacity))
        m = (
            self._focc[cand]
            & (self._fkey[cand] == ck[:, None])
            & (self._fstart[cand] == cs[:, None])
        )
        rows = cand.gather(1, _first_true(m)[:, None])[:, 0]
        return torch.where(m.any(dim=1), rows, -1)

    # -- batched open-addressing claim -----------------------------------------
    def _claim(self, owners, ck, cs, ce) -> torch.Tensor:
        """Claim a global row per (absent) cell; ``-1`` = spill — the same
        claim loop as the per-shard table, fed owner-segment windows."""
        return _claim_rows(
            self._fkey, self._fstart, self._fend, self._fvalue,
            self._fcount, self._ftouch, self._focc,
            self._probe_window(owners, cell_hash(ck, cs, self.capacity)),
            ck, cs, ce, self.stats,
        )

    # -- the whole-plane fused update ------------------------------------------
    def update(
        self, owners, cell_keys, cell_starts, cell_ends, value_sums, counts,
        touch_ts: int,
    ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Accumulate ALL shards' per-cell partials in one pass: one lookup
        launch, one claim loop, one scatter-add launch over the stacked
        planes.  Returns the spill as ``(owner, key, start, end, value,
        count)`` tensors (``None`` when nothing spilled)."""
        d = self.device
        ow = _i64(owners, d)
        ck, cs, ce = _i64(cell_keys, d), _i64(cell_starts, d), _i64(cell_ends, d)
        vs, cn = _i64(value_sums, d), _i64(counts, d)
        if not len(ck):
            return None
        rows = self.lookup(ow, ck, cs)
        miss = rows < 0
        n_miss = int(miss.sum())
        self.stats.hits += len(ck) - n_miss
        if n_miss:
            rows[miss] = self._claim(ow[miss], ck[miss], cs[miss], ce[miss])
        ok = rows >= 0
        r = rows[ok]
        ops.scatter_add_(self._fvc, r, torch.stack([vs[ok], cn[ok]], dim=1))
        self._ftouch[r] = torch.clamp_min(self._ftouch[r], int(touch_ts))
        if len(r) == len(ck):
            return None
        sp = ~ok
        return ow[sp], ck[sp], cs[sp], ce[sp], vs[sp], cn[sp]

    # -- batched watermark close / TTL eviction --------------------------------
    def _extract(self, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Remove masked rows; returns ``(owner, key, start, end, value,
        count, touch)`` in global (shard-major) row order."""
        idx = torch.nonzero(mask).flatten()
        out = (
            self.row_owner[idx].to(I64),
            self._fkey[idx], self._fstart[idx], self._fend[idx],
            self._fvalue[idx], self._fcount[idx], self._ftouch[idx],
        )
        self._focc[idx] = False
        return out

    def take_due(self, watermark: int) -> Tuple[torch.Tensor, ...]:
        """Remove and return every due row of EVERY shard (``end <=
        watermark``) in one mask over the stacked planes."""
        return self._extract(self._focc & (self._fend <= watermark))

    def evict_idle(self, watermark: int, ttl: int) -> Tuple[torch.Tensor, ...]:
        """One TTL sweep over all shards; the owner column routes each
        evicted row back to its shard's host tier."""
        out = self._extract(self._focc & (self._ftouch + ttl <= watermark))
        self.stats.evicted += len(out[0])
        return out

    def open_rows(self) -> Tuple[torch.Tensor, ...]:
        """Every occupied row of every shard (global row order), WITHOUT
        removing — the early-firing provisional-pane source."""
        idx = torch.nonzero(self._focc).flatten()
        return (
            self._fkey[idx], self._fstart[idx], self._fend[idx],
            self._fvalue[idx], self._fcount[idx],
        )

    def per_shard_occupancy(self) -> torch.Tensor:
        """Occupied-row count per shard."""
        return self.occ.sum(dim=1).to(I64)

    def per_shard_health(self) -> List[dict]:
        """One :meth:`DeviceWindowTable.health`-shaped snapshot per shard:
        probe distances are computed over the stacked planes on the device
        (a row's home is within its shard's own ring), the per-shard
        statistics on the host with numpy."""
        idx = torch.nonzero(self._focc).flatten()
        local = torch.remainder(idx, self.capacity)
        home = cell_hash(self._fkey[idx], self._fstart[idx], self.capacity)
        dist = torch.remainder(local - home, self.capacity).cpu().numpy()
        shard = (idx // self.capacity).cpu().numpy()
        out = []
        for w in range(self.n_shards):
            d = dist[shard == w]
            mean, mx = _probe_distance_stats(d)
            out.append({
                "capacity": self.capacity,
                "occupancy": int(len(d)),
                "load_factor": len(d) / self.capacity,
                "probe_mean": mean,
                "probe_max": mx,
            })
        return out
