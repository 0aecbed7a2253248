"""Keyed window operators: tumbling / sliding / session with watermarks.

Port of ``repro/keyed/windows.py``.  The engine realizes the serial
semantics of the reference's ``core.semantics.keyed_windows``
chunk-at-a-time:

* every item ``(key, value, ts)`` is expanded to its window assignments
  (tumbling is sliding with ``slide == size``; session items become per-key
  fragments under the gap rule);
* assignments whose window already fired against the current watermark are
  **late** — recorded, and shipped as a side output under
  ``late_policy="side"``;
* live assignments are reduced to per-cell partials through
  :func:`repro_torch.keyed.kernels.reduce_by_cell` (the CUDA segment-sum
  kernel on the card) and merged into windowed state;
* the watermark ``max(ts) - lateness`` advances at the chunk boundary and
  fires every window with ``end <= wm`` in ``(end, start, key)`` order.

Windowed state lives in one of two **backends**: ``"host"`` (every open
window in the dict-of-dicts :class:`~repro_torch.keyed.store.KeyedStore`)
or ``"device_table"`` (tumbling/sliding cells in a
:class:`~repro_torch.keyed.table.DeviceWindowTable` on the engine's device,
with the host store as the spill tier).  Session windows merge by interval
overlap, so they stay host-side, as in the reference.

Pane expansion, cell dedup, the reduce and the table update run on the
engine's device; what leaves the engine (emissions, early firings, late
records, snapshots) is host numpy with the reference's dtypes and order.
The snapshot is canonical and backend-agnostic: open windows from both tiers
merged into one sorted row set (``w_*`` columns) with the residency and
last-touch placement columns (``w_resident`` / ``w_touch``) and the ``t_*``
placement counters — the reference's layout key for key.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.keyed import kernels as kk
from repro_torch.keyed.store import KeyedStore, SlotMap, WindowState, hash_to_slot
from repro_torch.keyed.table import DeviceWindowTable

BACKENDS = ("host", "device_table")

_FIRE_COLS = ("key", "start", "end", "value", "count")


def _empty_cols(n: int = 5) -> Tuple[np.ndarray, ...]:
    return tuple(np.zeros(0, np.int64) for _ in range(n))


def to_host(cols) -> Tuple[np.ndarray, ...]:
    """Device columns -> host int64 numpy columns."""
    return tuple(np.asarray(c.cpu().numpy(), np.int64) for c in cols)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Window kind + parameters + late-data policy (all event-time ints)."""

    kind: str                  # "tumbling" | "sliding" | "session"
    size: int = 0
    slide: int = 0
    gap: int = 0
    lateness: int = 0          # out-of-orderness bound: wm = max_ts - lateness
    late_policy: str = "drop"  # "drop" | "side"
    early_every: int = 0       # provisional pane firing every N wm ticks

    def __post_init__(self):
        if self.kind not in ("tumbling", "sliding", "session"):
            raise ValueError(f"unknown window kind {self.kind!r}")
        if self.late_policy not in ("drop", "side"):
            raise ValueError(f"unknown late policy {self.late_policy!r}")
        if self.early_every < 0:
            raise ValueError(f"early_every must be >= 0, got {self.early_every}")
        if self.kind == "session":
            if self.gap <= 0:
                raise ValueError("session windows need gap > 0")
        else:
            if self.size <= 0:
                raise ValueError(f"{self.kind} windows need size > 0")
            if self.kind == "sliding" and not 0 < self.slide <= self.size:
                raise ValueError("sliding windows need 0 < slide <= size")
        if self.lateness < 0:
            raise ValueError("lateness must be >= 0")

    @property
    def effective_slide(self) -> int:
        return self.size if self.kind == "tumbling" else self.slide

    def oracle_kwargs(self, watermark_every: int) -> dict:
        """kwargs for the reference's ``core.semantics.keyed_windows``."""
        return dict(
            size=self.size, slide=self.slide, gap=self.gap,
            watermark_every=watermark_every, lateness=self.lateness,
            late_policy=self.late_policy, early_every=self.early_every,
        )


def _emission_dict(cols: Tuple[np.ndarray, ...]) -> Dict[str, np.ndarray]:
    return {k: np.asarray(c, np.int64) for k, c in zip(_FIRE_COLS, cols)}


def _rows_to_cols(rows: List[Tuple[int, ...]], n: int = 5):
    if not rows:
        return _empty_cols(n)
    cols = np.asarray(rows, np.int64).reshape(-1, n).T
    return tuple(cols[i].copy() for i in range(n))


def _concat_cols(parts) -> Tuple[np.ndarray, ...]:
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return _empty_cols(len(_FIRE_COLS))
    if len(parts) == 1:
        return tuple(parts[0])
    return tuple(np.concatenate(c) for c in zip(*parts))


def _group_starts(*sorted_cols) -> np.ndarray:
    """Indices where any of the (already sorted) columns changes."""
    n = len(sorted_cols[0])
    diff = np.zeros(n, bool)
    diff[0] = True
    for c in sorted_cols:
        diff[1:] |= c[1:] != c[:-1]
    return np.flatnonzero(diff)


def merge_fire(key, start, end, value, count) -> Dict[str, np.ndarray]:
    """Merge per-tier partials of the same cell and order the emission in
    the oracle's ``(end, start, key)`` fire order — the reference's
    dict-based ``_merge_fire``, vectorized (sum + count are integer and
    associative, so the grouped sums are identical)."""
    key = np.asarray(key, np.int64)
    if not len(key):
        return _emission_dict(_empty_cols())
    order = np.lexsort((key, start, end))
    k, s, e = key[order], np.asarray(start)[order], np.asarray(end)[order]
    g = _group_starts(e, s, k)
    return _emission_dict((
        k[g], s[g], e[g],
        np.add.reduceat(np.asarray(value, np.int64)[order], g),
        np.add.reduceat(np.asarray(count, np.int64)[order], g),
    ))


def canonical_rows(host_cols, table_cols) -> Tuple[np.ndarray, ...]:
    """Merge host-tier rows ``(key, start, end, value, count)`` and table
    rows ``(key, start, end, value, count, touch)`` into the canonical
    snapshot rows ``(key, start, end, value, count, resident, touch)``
    sorted by ``(key, start, end)``: a cell split across tiers sums its
    partials, is marked resident and carries the table row's touch."""
    n_h, n_t = len(host_cols[0]), len(table_cols[0])
    cols = [np.concatenate([np.asarray(h, np.int64), np.asarray(t, np.int64)])
            for h, t in zip(host_cols, table_cols[:5])]
    resident = np.concatenate([np.zeros(n_h, np.int64), np.ones(n_t, np.int64)])
    touch = np.concatenate([np.zeros(n_h, np.int64),
                            np.asarray(table_cols[5], np.int64)])
    if not len(resident):
        return _empty_cols(7)
    order = np.lexsort((cols[2], cols[1], cols[0]))
    k, s, e = (c[order] for c in cols[:3])
    g = _group_starts(k, s, e)
    res = resident[order]
    return (
        k[g], s[g], e[g],
        np.add.reduceat(cols[3][order], g),
        np.add.reduceat(cols[4][order], g),
        np.maximum.reduceat(res, g),
        np.add.reduceat(touch[order] * res, g),
    )


def expand_panes(
    spec: "WindowSpec", keys, values, ts, pos,
) -> Tuple[torch.Tensor, ...]:
    """Expand items to their tumbling/sliding pane assignments in one
    vectorized pass on the items' device: item-major, newest pane first
    (the serial oracle's per-item order), with the validity mask applied.

    Returns ``(key, value, ts, pos, start)`` int64 tensors — one row per
    (item, pane) assignment.  State-independent, so the executor's pipeline
    may run it ahead of the owning chunk."""
    size, slide = spec.size, spec.effective_slide
    panes = -(-size // slide)
    hi = torch.div(ts, slide, rounding_mode="floor") * slide
    offs = torch.arange(panes, dtype=torch.int64, device=ts.device) * slide
    starts = hi[:, None] - offs[None, :]
    sel = (starts > (ts - size)[:, None]).reshape(-1)

    def rep(a):
        return torch.repeat_interleave(a, panes)[sel]

    return rep(keys), rep(values), rep(ts), rep(pos), starts.reshape(-1)[sel]


def merge_session_fragment(
    store: KeyedStore, key: int, lo: int, hi: int, vsum: int, cnt: int,
) -> None:
    """Fold one session fragment ``[lo, hi)`` into ``store``'s window list
    for ``key``: every open window it strictly overlaps is absorbed —
    bounds extend, aggregates sum — and the key's list stays start-sorted."""
    wins = store.windows_of(key)
    merged = WindowState(lo, hi, vsum, cnt)
    keep = []
    for w in wins:
        if w.start < merged.end and merged.start < w.end:
            merged.start = min(merged.start, w.start)
            merged.end = max(merged.end, w.end)
            merged.value += w.value
            merged.count += w.count
        else:
            keep.append(w)
    keep.append(merged)
    keep.sort(key=lambda w: w.start)
    store.slots[store.slot_of(key)][key] = keep


def session_fragments(keys, values, ts, gap: int):
    """Sort live session items by ``(key, ts)`` and cut them into per-key
    fragments under the gap rule.  Returns ``(frag_ids, values_sorted,
    frag_keys, frag_lo, frag_hi)`` host arrays."""
    order = np.lexsort((ts, keys))
    ks, vs, ts_s = keys[order], values[order], ts[order]
    new_frag = np.ones(len(ks), bool)
    chain = (ks[1:] == ks[:-1]) & ((ts_s[1:] - ts_s[:-1]) < gap)
    new_frag[1:] = ~chain
    frag_ids = np.cumsum(new_frag) - 1
    first = np.flatnonzero(new_frag)
    last = np.append(first[1:], len(ks)) - 1
    return frag_ids, vs, ks[first], ts_s[first], ts_s[last] + gap


def reduce_on_device(ids: np.ndarray, vals: np.ndarray, n: int, impl: str,
                     device) -> np.ndarray:
    """``reduce_by_cell`` of host ``ids`` / value rows on ``device``, with
    the ``(value, 1)`` count column; returns host int64 ``[n, 2]``."""
    v = torch.as_tensor(vals, dtype=torch.int64, device=device)
    sums = kk.reduce_by_cell(
        torch.as_tensor(ids, dtype=torch.int32, device=device),
        torch.stack([v, torch.ones_like(v)], dim=1), n, impl=impl,
    )
    return sums.cpu().numpy().astype(np.int64)


class KeyedWindowEngine:
    """Chunked keyed-window executor over tiered keyed state.

    ``backend="host"`` keeps every open window in the slot-mapped
    :class:`KeyedStore`; ``backend="device_table"`` runs tumbling/sliding
    cells on a :class:`DeviceWindowTable` of ``capacity`` rows on
    ``device`` with optional ``ttl`` eviction (watermark units), spilling
    to the host store.  Session windows always run host-side.
    """

    def __init__(
        self,
        spec: WindowSpec,
        *,
        num_slots: int,
        n_workers: int = 1,
        impl: str = "segment",
        store: Optional[KeyedStore] = None,
        backend: str = "host",
        capacity: int = 1024,
        ttl: Optional[int] = None,
        max_probes: int = 16,
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if ttl is not None and ttl < 0:
            raise ValueError(f"ttl must be >= 0, got {ttl}")
        self.spec = spec
        self.device = resolve_device(device)
        self.store = store or KeyedStore(num_slots, n_workers)
        self.impl = impl
        self.backend = backend
        self.capacity = capacity
        self.ttl = ttl
        self.max_probes = max_probes
        # sessions merge by interval overlap (variable bounds) — host-side
        self.table: Optional[DeviceWindowTable] = (
            DeviceWindowTable(capacity, max_probes=max_probes,
                              device=self.device)
            if backend == "device_table" and spec.kind != "session"
            else None
        )
        self.wm: Optional[int] = None
        self.max_ts: Optional[int] = None
        self.wm_ticks = 0  # watermark advances seen (early-firing cadence)
        # late assignments of the chunk being processed, stream order; only
        # the running count is part of the snapshot
        self._chunk_late: List[Tuple[np.ndarray, ...]] = []
        self._chunk_touch: Optional[int] = None
        self.late_count = 0
        # per-owner live-assignment counts (the §4.2 work distribution)
        self.worker_items = np.zeros(self.store.n_workers, np.int64)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -- chunk processing ------------------------------------------------------
    def process_chunk(
        self, chunk, *, wm_ts: Optional[int] = None, positions=None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Process one chunk (dict or structured array with ``key`` /
        ``value`` / ``ts`` fields); returns ``{"emissions": ..., "late":
        ..., "early": ...}`` as fixed-key host column dicts.

        ``wm_ts`` is the watermark clock of a **sharded** run (the whole
        chunk's ``max(ts)``, so every shard advances and ticks alike);
        ``positions`` (the items' indices in the un-routed chunk) ride along
        on the late side-output as a ``pos`` column."""
        keys = np.asarray(chunk["key"], np.int64)
        values = np.asarray(chunk["value"], np.int64)
        ts = np.asarray(chunk["ts"], np.int64)
        pos = (
            np.asarray(positions, np.int64) if positions is not None
            else np.arange(len(keys), dtype=np.int64)
        )
        self._chunk_late = []
        if len(keys):
            self._chunk_touch = int(ts.max()) if wm_ts is None else int(wm_ts)
            if self.spec.kind == "session":
                self._process_sessions(keys, values, ts, pos)
            else:
                self._process_panes(keys, values, ts, pos)
            chunk_max = int(ts.max())
            self.max_ts = (
                chunk_max if self.max_ts is None else max(self.max_ts, chunk_max)
            )
        if wm_ts is not None:
            self.max_ts = (
                int(wm_ts) if self.max_ts is None
                else max(self.max_ts, int(wm_ts))
            )
        emissions, early = self._advance_watermark(
            ticked=bool(len(keys)) or wm_ts is not None
        )
        late = _concat_cols(self._chunk_late) if self._chunk_late \
            else _empty_cols()
        self.late_count += len(late[0])
        if self.spec.late_policy == "side" and len(late[0]):
            late_out = dict(key=late[0], value=late[1], ts=late[2],
                            start=late[3])
            late_pos = late[4]
        else:
            late_out = {k: np.zeros(0, np.int64)
                        for k in ("key", "value", "ts", "start")}
            late_pos = np.zeros(0, np.int64)
        if positions is not None:
            late_out["pos"] = late_pos
        return {"emissions": emissions, "late": late_out, "early": early}

    # -- host-store merge (the spill path and the host backend) ----------------
    def _merge_into_store(self, keys, starts, ends, vsums, counts) -> None:
        """Fold per-cell partials into the host store, grouped by key: one
        lexsort groups the rows by ``(key, start)``, each key's batch merges
        into its start-sorted window list with a bisect per row and one
        extend + sort for the new windows (the reference's algorithm)."""
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        if not n:
            return
        order = np.lexsort((np.asarray(starts, np.int64), keys))
        ks = keys[order].tolist()
        ss = np.asarray(starts, np.int64)[order].tolist()
        es = np.asarray(ends, np.int64)[order].tolist()
        vs = np.asarray(vsums, np.int64)[order].tolist()
        cs = np.asarray(counts, np.int64)[order].tolist()
        i = 0
        while i < n:
            key = ks[i]
            j = i + 1
            while j < n and ks[j] == key:
                j += 1
            wins = self.store.windows_of(key)
            wstarts = [w.start for w in wins]
            fresh: List[WindowState] = []
            for r in range(i, j):
                s = ss[r]
                p = bisect.bisect_left(wstarts, s)
                if p < len(wstarts) and wstarts[p] == s:
                    w = wins[p]
                    w.value += vs[r]
                    w.count += cs[r]
                elif fresh and fresh[-1].start == s:
                    fresh[-1].value += vs[r]
                    fresh[-1].count += cs[r]
                else:
                    fresh.append(WindowState(s, es[r], vs[r], cs[r]))
            if fresh:
                wins.extend(fresh)
                wins.sort(key=lambda w: w.start)
            i = j

    # -- tumbling / sliding ----------------------------------------------------
    def _process_panes(self, keys, values, ts, pos) -> None:
        size = self.spec.size
        a_key, a_val, a_ts, a_pos, a_start = expand_panes(
            self.spec, *(self._tensor(a) for a in (keys, values, ts, pos))
        )
        if self.wm is not None:
            late = (a_start + size) <= self.wm
            if bool(late.any()):
                self._chunk_late.append(to_host(
                    (a_key[late], a_val[late], a_ts[late], a_start[late],
                     a_pos[late])
                ))
                live = ~late
                a_key, a_val, a_start = a_key[live], a_val[live], a_start[live]
        if not len(a_key):
            return
        cells, inv = kk.dedup_cells(a_key, a_start)
        partial = kk.reduce_by_cell(
            inv.to(torch.int32), torch.stack([a_val, torch.ones_like(a_val)], 1),
            len(cells), impl=self.impl,
        ).to(torch.int64)
        c_keys, c_starts = cells[:, 0], cells[:, 1]
        self._account_work(*to_host((c_keys, partial[:, 1])))
        if self.table is not None:
            # the device-table update: lookup/claim + accumulate; the
            # probe-window overflow (if any) spills to the host tier
            spill = self.table.update(
                c_keys, c_starts, c_starts + size,
                partial[:, 0], partial[:, 1], touch_ts=self._chunk_touch,
            )
            if spill is not None:
                self._merge_into_store(*to_host(spill))
        else:
            self._merge_into_store(*to_host(
                (c_keys, c_starts, c_starts + size, partial[:, 0],
                 partial[:, 1])
            ))

    # -- session ---------------------------------------------------------------
    def _process_sessions(self, keys, values, ts, pos) -> None:
        gap = self.spec.gap
        if self.wm is not None:
            late_mask = (ts + gap) <= self.wm
        else:
            late_mask = np.zeros(len(ts), bool)
        if late_mask.any():
            self._chunk_late.append((
                keys[late_mask], values[late_mask], ts[late_mask],
                ts[late_mask], pos[late_mask],
            ))
        live = ~late_mask
        k, v, t = keys[live], values[live], ts[live]
        if not len(k):
            return
        frag_ids, vs, frag_keys, frag_lo, frag_hi = session_fragments(
            k, v, t, gap
        )
        sums = reduce_on_device(frag_ids, vs, int(frag_ids[-1]) + 1,
                                self.impl, self.device)
        self._account_work(frag_keys, sums[:, 1])
        for key, lo, hi, (vsum, cnt) in zip(
            frag_keys.tolist(), frag_lo.tolist(), frag_hi.tolist(),
            sums.tolist(),
        ):
            merge_session_fragment(self.store, key, lo, hi, vsum, cnt)

    def _account_work(self, cell_keys, per_cell_counts) -> None:
        slots = hash_to_slot(cell_keys, self.store.num_slots).astype(np.int64)
        owners = self.store.slot_map.table[slots]
        np.add.at(self.worker_items, owners, np.asarray(per_cell_counts))

    # -- watermark / emission --------------------------------------------------
    def _store_due(self) -> List[Tuple[int, int, int, int, int]]:
        """Remove and return the host-store rows with ``end <= wm``."""
        due = []
        for slot_dict in self.store.slots:
            for key, wins in slot_dict.items():
                for w in wins:
                    if w.end <= self.wm:
                        due.append((key, w.start, w.end, w))
        rows = []
        for key, start, end, w in due:
            rows.append((key, start, end, w.value, w.count))
            slot_dict = self.store.slots[self.store.slot_of(key)]
            slot_dict[key].remove(w)
            if not slot_dict[key]:
                del slot_dict[key]
        return rows

    def _store_rows(self) -> Tuple[np.ndarray, ...]:
        """Every host-tier open window as 5 columns."""
        return _rows_to_cols([
            (k, w.start, w.end, w.value, w.count)
            for slot_dict in self.store.slots
            for k, wins in slot_dict.items()
            for w in wins
        ])

    def _open_cols(self) -> Tuple[np.ndarray, ...]:
        """Every open window of both tiers as raw (unmerged) columns."""
        parts = [self._store_rows()]
        if self.table is not None:
            rows = self.table.rows().cpu().numpy()
            parts.append(tuple(rows[:, i].copy() for i in range(5)))
        return _concat_cols(parts)

    def _advance_watermark(
        self, ticked: bool = True
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Advance wm, fire due windows; returns ``(emissions, early)``.
        ``ticked`` counts this advance toward the early-firing cadence."""
        if self.max_ts is None:
            return merge_fire(*_empty_cols()), merge_fire(*_empty_cols())
        new_wm = self.max_ts - self.spec.lateness
        self.wm = new_wm if self.wm is None else max(self.wm, new_wm)
        parts = [_rows_to_cols(self._store_due())]
        if self.table is not None:
            parts.append(to_host(self.table.take_due(self.wm)[:5]))
            if self.ttl is not None:
                e = self.table.evict_idle(self.wm, self.ttl)
                # idle rows change tier, not value: merge into the host store
                self._merge_into_store(*to_host(e[:5]))
        early = merge_fire(*_empty_cols())
        if ticked:
            self.wm_ticks += 1
            if (
                self.spec.early_every
                and self.wm_ticks % self.spec.early_every == 0
            ):
                # provisional panes: running aggregates of every still-open
                # window, merged across tiers — never closes a window
                early = merge_fire(*self._open_cols())
        return merge_fire(*_concat_cols(parts)), early

    def flush(self) -> Dict[str, np.ndarray]:
        """End-of-stream: fire every remaining window (watermark -> +inf).
        Not part of the oracle contract — a convenience for applications."""
        cols = self._open_cols()
        if self.table is not None:
            self.table.clear()
        self.store = KeyedStore(
            self.store.num_slots, self.store.n_workers,
            slot_map=self.store.slot_map,
        )
        return merge_fire(*cols)

    # -- row-level slot migration (the §4.2 DMA path) --------------------------
    def extract_rows(self, slots) -> Tuple[np.ndarray, ...]:
        """Remove and return the canonical snapshot rows of ``slots`` from
        BOTH tiers, as ``(key, start, end, value, count, resident, touch)``
        host int64 arrays sorted by ``(key, start, end)`` — the donor half
        of a slot migration."""
        slots = np.asarray(slots, np.int64)
        host = _rows_to_cols(self.store.extract_slot_rows(slots))
        table = _empty_cols(6)
        if self.table is not None and len(slots):
            table = to_host(
                self.table.extract_slot_rows(slots, self.store.num_slots)
            )
        return canonical_rows(host, table)

    def ingest_rows(
        self, key, start, end, value, count, resident, touch,
    ) -> None:
        """Adopt canonical rows shipped by a donor shard (the recipient half
        of a slot migration).  Table-resident rows re-place into this
        engine's table (overflow spills to the host tier); host rows merge
        into the store."""
        key = np.asarray(key, np.int64)
        if not len(key):
            return
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        value = np.asarray(value, np.int64)
        count = np.asarray(count, np.int64)
        touch = np.asarray(touch, np.int64)
        res = (
            np.asarray(resident, np.int64) != 0
            if self.table is not None else np.zeros(len(key), bool)
        )
        self._merge_into_store(
            key[~res], start[~res], end[~res], value[~res], count[~res]
        )
        if self.table is not None and res.any():
            over = self.table.insert_rows(
                key[res], start[res], end[res], value[res], count[res],
                touch[res],
            )
            if over is not None:  # recipient table full: host tier absorbs
                self._merge_into_store(*to_host(over[:5]))

    # -- checkpoint round-trip -------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Canonical, backend-agnostic state: one merged row per open cell
        (sorted by ``(key, start, end)``), with residency/touch placement
        columns, plus watermark scalars and placement counters."""
        table = _empty_cols(6)
        if self.table is not None:
            rows = self.table.rows().cpu().numpy()
            table = tuple(rows[:, i].copy() for i in range(6))
        cols = canonical_rows(self._store_rows(), table)
        stats = self.table.stats if self.table is not None else None
        return {
            "slot_table": self.store.slot_map.table.copy(),
            "n_workers": np.int64(self.store.slot_map.n_workers),
            "w_key": cols[0],
            "w_start": cols[1],
            "w_end": cols[2],
            "w_value": cols[3],
            "w_count": cols[4],
            "w_resident": cols[5],
            "w_touch": cols[6],
            "wm": np.int64(self.wm if self.wm is not None else 0),
            "wm_valid": np.int64(self.wm is not None),
            "wm_ticks": np.int64(self.wm_ticks),
            "max_ts": np.int64(self.max_ts if self.max_ts is not None else 0),
            "max_ts_valid": np.int64(self.max_ts is not None),
            "late_count": np.int64(self.late_count),
            "worker_items": self.worker_items.copy(),
            "t_inserted": np.int64(stats.inserted if stats else 0),
            "t_hits": np.int64(stats.hits if stats else 0),
            "t_spilled": np.int64(stats.spilled if stats else 0),
            "t_evicted": np.int64(stats.evicted if stats else 0),
        }

    @classmethod
    def restore(
        cls, spec: WindowSpec, tree: Dict[str, np.ndarray], *,
        impl: str = "segment", backend: str = "host", capacity: int = 1024,
        ttl: Optional[int] = None, max_probes: int = 16, owned_slots=None,
        device=None,
    ) -> "KeyedWindowEngine":
        """Rebuild an engine from its canonical snapshot.  ``owned_slots``
        loads only the rows whose key hashes to one of those slots (a
        shard's slice of the shared snapshot)."""
        slot_table = np.asarray(tree["slot_table"], np.int32)
        n_workers = int(tree["n_workers"])
        store = KeyedStore(
            len(slot_table), n_workers,
            slot_map=SlotMap(len(slot_table), n_workers, table=slot_table),
        )
        eng = cls(
            spec, num_slots=store.num_slots, impl=impl, store=store,
            backend=backend, capacity=capacity, ttl=ttl, max_probes=max_probes,
            device=device,
        )
        key = np.asarray(tree["w_key"], np.int64)
        start = np.asarray(tree["w_start"], np.int64)
        end = np.asarray(tree["w_end"], np.int64)
        value = np.asarray(tree["w_value"], np.int64)
        count = np.asarray(tree["w_count"], np.int64)
        # placement columns are optional: a host-only snapshot has no
        # residency metadata — every row restores into the store
        resident = np.asarray(
            tree.get("w_resident", np.zeros(len(key), np.int64)), np.int64
        )
        touch = np.asarray(
            tree.get("w_touch", np.zeros(len(key), np.int64)), np.int64
        )
        if owned_slots is not None:
            own = np.isin(
                hash_to_slot(key, len(slot_table)).astype(np.int64),
                np.asarray(owned_slots, np.int64),
            )
            key, start, end = key[own], start[own], end[own]
            value, count = value[own], count[own]
            resident, touch = resident[own], touch[own]
        if eng.table is None:
            resident = np.zeros(len(key), np.int64)
        res = resident != 0
        for k, s, e, v, c in zip(
            key[~res].tolist(), start[~res].tolist(), end[~res].tolist(),
            value[~res].tolist(), count[~res].tolist(),
        ):
            store.windows_of(k).append(WindowState(s, e, v, c))
        if eng.table is not None and res.any():
            over = eng.table.insert_rows(
                key[res], start[res], end[res], value[res], count[res],
                touch[res],
            )
            if over is not None:  # capacity shrank since the snapshot: spill
                eng._merge_into_store(*to_host(over[:5]))
        eng.wm = int(tree["wm"]) if int(tree["wm_valid"]) else None
        eng.max_ts = int(tree["max_ts"]) if int(tree["max_ts_valid"]) else None
        eng.wm_ticks = int(tree.get("wm_ticks", 0))
        eng.late_count = int(tree["late_count"])
        eng.worker_items = np.asarray(tree["worker_items"], np.int64).copy()
        if eng.table is not None:
            eng.table.stats.inserted = int(tree.get("t_inserted", 0))
            eng.table.stats.hits = int(tree.get("t_hits", 0))
            eng.table.stats.spilled = int(tree.get("t_spilled", 0))
            eng.table.stats.evicted = int(tree.get("t_evicted", 0))
        return eng
