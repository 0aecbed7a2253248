"""Runtime integration: the sharded keyed state plane under the executor.

Port of ``repro/keyed/runtime.py``.  :class:`KeyedWindowAdapter` is a
**live-state host adapter** (``is_host`` + ``has_live_state``): it keeps
``n_w`` live engine shards, one per worker, each owning exactly the slots
the :class:`~repro_torch.keyed.store.SlotMap` assigns it (the paper's §4.2
fully-partitioned ownership):

* ``step_live`` runs each chunk as the **fused all-shard pass**
  (``fused=True``): route once, expand panes once, dedup cells once, one
  reduce, ONE batched table lookup + scatter-add over the stacked
  :class:`~repro_torch.keyed.table.BatchedWindowTable` planes, one global
  watermark close — or, with ``fused=False``, the per-shard loop; outputs
  are bit-identical either way and merge into the serial oracle's order;
* ``resize_live`` is the row-level migration plane: only the canonical
  rows of reassigned slots move from donor to recipient shards;
* ``snapshot_barrier`` merges per-shard snapshots into THE canonical form.

The table planes and the per-chunk pane / cell tensors live on the
adapter's ``device``; emissions, early firings, late records and snapshots
come back as host numpy in the reference's dtypes and order.  When the
adapter's tracer is enabled, every stage span synchronizes the device
before it closes, so the ``FUSED_STAGES`` spans time device work rather
than launches.  ``live=False`` keeps the snapshot-per-chunk path.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.keyed import kernels as kk
from repro_torch.keyed.store import (
    SlotMap,
    fold_worker_items,
    hash_to_slot,
)
from repro_torch.keyed.table import BatchedWindowTable, TableStats
from repro_torch.keyed.windows import (
    KeyedWindowEngine,
    WindowSpec,
    _concat_cols,
    _empty_cols,
    _rows_to_cols,
    expand_panes,
    merge_fire,
    merge_session_fragment,
    reduce_on_device,
    session_fragments,
    to_host,
)
from repro_torch.runtime.executor import PatternAdapter, ResizeInfo

#: structured dtype of one keyed stream item
ITEM_DTYPE = np.dtype(
    [("key", np.int64), ("value", np.int64), ("ts", np.int64)]
)

#: canonical snapshot row width: 7 int64 columns (key, start, end, value,
#: count, resident, touch) — what a migrated row costs on the wire
ROW_BYTES = 7 * 8

_ROW_COLS = (
    "w_key", "w_start", "w_end", "w_value", "w_count", "w_resident", "w_touch"
)
_STAT_KEYS = ("t_inserted", "t_hits", "t_spilled", "t_evicted")

#: the six fused-pipeline stage span names, in execution order
FUSED_STAGES = (
    "route", "expand_panes", "dedup_cells", "reduce_by_cell",
    "table_update", "close",
)


def keyed_stream(keys, values, ts) -> np.ndarray:
    """Pack columns into the keyed item record array sources/queues carry."""
    out = np.empty(len(keys), ITEM_DTYPE)
    out["key"], out["value"], out["ts"] = keys, values, ts
    return out


def synthetic_keyed_items(
    n: int, *, num_keys: int, max_value: int = 100, disorder: int = 0,
    seed: int = 0,
) -> np.ndarray:
    """Deterministic keyed stream: timestamps advance one per item with a
    bounded out-of-order jitter of ``disorder`` — the bounded
    out-of-orderness the watermark's ``lateness`` knob models."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, num_keys, size=n)
    values = rng.integers(0, max_value, size=n)
    ts = np.arange(n, dtype=np.int64)
    if disorder:
        ts = ts + rng.integers(-disorder, disorder + 1, size=n)
    return keyed_stream(keys, values, ts)


def _take(chunk, idx):
    """Row-select a chunk (structured array or dict of columns)."""
    if isinstance(chunk, np.ndarray):
        return chunk[idx]
    return {k: np.asarray(v)[idx] for k, v in chunk.items()}


def _concat_sorted(parts: List[Dict[str, np.ndarray]], keys) -> Dict:
    """Merge per-shard emission dicts into global ``(end, start, key)``
    fire order (shards hold disjoint cells, so a sort IS the merge); empty
    parts short-circuit."""
    live = [p for p in parts if len(p[keys[0]])]
    if not live:
        return {k: np.zeros(0, np.int64) for k in keys}
    if len(live) == 1:
        return {k: live[0][k] for k in keys}
    cols = {k: np.concatenate([p[k] for p in live]) for k in keys}
    order = np.lexsort((cols["key"], cols["start"], cols["end"]))
    return {k: v[order] for k, v in cols.items()}


def merge_shard_snapshots(
    snaps: List[Dict[str, np.ndarray]], slot_table: np.ndarray,
    n_workers: int,
) -> Dict[str, np.ndarray]:
    """Merge per-shard engine snapshots into THE canonical snapshot: rows
    are disjoint so a canonical ``(key, start, end)`` lexsort is the merge,
    the watermark clock is shared so shard 0 speaks for all, and
    counters/tallies are sums."""
    cols = {
        k: np.concatenate([s[k] for s in snaps]) for k in _ROW_COLS
    }
    order = np.lexsort(
        (cols["w_end"], cols["w_start"], cols["w_key"])
    )
    out = {k: v[order] for k, v in cols.items()}
    out["slot_table"] = np.asarray(slot_table, np.int32).copy()
    out["n_workers"] = np.int64(n_workers)
    for k in ("wm", "wm_valid", "wm_ticks", "max_ts", "max_ts_valid"):
        out[k] = snaps[0][k]  # the watermark clock is shared
    out["late_count"] = np.int64(
        sum(int(s["late_count"]) for s in snaps)
    )
    out["worker_items"] = np.sum(
        [s["worker_items"] for s in snaps], axis=0, dtype=np.int64
    )
    for k in _STAT_KEYS:
        out[k] = np.int64(sum(int(s[k]) for s in snaps))
    return out


class KeyedWindowAdapter(PatternAdapter):
    """Keyed windowed state as a sharded live plane under the executor.

    ``backend="device_table"`` gives every shard its own device table
    (``capacity`` rows *per shard*, optional ``ttl`` eviction, host-store
    spill tier) on ``device``; the barrier snapshot makes both backends
    indistinguishable to the executor.  ``live=False`` restores the
    one-global-engine, snapshot-per-chunk behavior.
    """

    is_host = True

    def __init__(self, spec: WindowSpec, *, num_slots: int,
                 impl: str = "segment", backend: str = "host",
                 capacity: int = 1024, ttl: int | None = None,
                 max_probes: int = 16, live: bool = True,
                 fused: bool = True, device=None):
        self.spec = spec
        self.num_slots = num_slots
        self.impl = impl
        self.backend = backend
        self.capacity = capacity
        self.ttl = ttl
        self.max_probes = max_probes
        self.device = resolve_device(device)
        self.has_live_state = bool(live)
        #: fused=True executes each chunk as ONE vectorized pass over all
        #: shards; fused=False keeps the per-shard loop — bit-identical
        self.fused = bool(fused)
        self._shards: Optional[List[KeyedWindowEngine]] = None
        self._slot_map: Optional[SlotMap] = None
        self._slot_owner: Optional[torch.Tensor] = None
        self._batched: Optional[BatchedWindowTable] = None

    def _engine_kwargs(self):
        return dict(
            impl=self.impl, backend=self.backend, capacity=self.capacity,
            ttl=self.ttl, max_probes=self.max_probes, device=self.device,
        )

    @contextlib.contextmanager
    def _stage(self, name: str, **args):
        """A tracer span around one stage; with tracing on, the device is
        synchronized before the span closes so it covers the stage's
        device work."""
        with self.tracer.span(name, **args):
            yield
            if self.tracer.enabled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    @property
    def shards(self) -> Optional[List[KeyedWindowEngine]]:
        """The live engine shards (None while detached)."""
        return self._shards

    def init_state(self):
        return KeyedWindowEngine(
            self.spec, num_slots=self.num_slots, **self._engine_kwargs()
        ).snapshot()

    def validate_degree(self, chunk_size: int, n_w: int) -> None:
        # shards by ownership, not array layout: any worker count in
        # [1, num_slots] is feasible, for any chunk size
        if not 1 <= n_w <= self.num_slots:
            raise ValueError(
                f"worker count must be in [1, num_slots={self.num_slots}], "
                f"got {n_w}"
            )

    # -- live-state lifecycle --------------------------------------------------
    def _set_slot_map(self, sm: SlotMap) -> None:
        self._slot_map = sm
        self._slot_owner = torch.as_tensor(sm.table, dtype=torch.int64,
                                           device=self.device)

    def attach(self, state, n_w: int) -> None:
        """Hydrate ``n_w`` live shards from the canonical snapshot: each
        shard restores ONLY the rows of its owned slots."""
        slot_table = np.asarray(state["slot_table"], np.int32)
        n_cur = int(state["n_workers"])
        sm = SlotMap(len(slot_table), n_cur, table=slot_table)
        if n_cur != n_w:
            # degree alignment (a snapshot written at another degree): fold
            # tallies along with ownership
            new_sm, _ = sm.rebalance(n_w)
            state = dict(
                state, slot_table=new_sm.table, n_workers=np.int64(n_w),
                worker_items=fold_worker_items(
                    np.asarray(state["worker_items"], np.int64),
                    sm.table, new_sm.table, n_w,
                ),
            )
            sm = new_sm
        worker_items = np.asarray(state["worker_items"], np.int64)
        shards = []
        for w in range(n_w):
            eng = KeyedWindowEngine.restore(
                self.spec, state, owned_slots=sm.slots_of(w),
                **self._engine_kwargs(),
            )
            # shard w carries only its own tally; the stream-global counters
            # (late count, table stats) live on shard 0 — the barrier sums
            items = np.zeros(n_w, np.int64)
            items[w] = worker_items[w] if w < len(worker_items) else 0
            eng.worker_items = items
            if w:
                eng.late_count = 0
                if eng.table is not None:
                    eng.table.stats = TableStats()
            shards.append(eng)
        self._shards = shards
        self._set_slot_map(sm)
        self._rebuild_batched()

    def _rebuild_batched(self) -> None:
        """(Re)form the fused plane's batched view after attach and after a
        resize.  Attach stacks once into an over-allocated plane; resizes go
        through :meth:`BatchedWindowTable.restack`, which reuses survivors'
        unmoved segments."""
        if not (self.fused and self._shards[0].table is not None):
            self._batched = None
            return
        tables = [s.table for s in self._shards]
        if self._batched is None:
            reserve = min(self.num_slots, max(2 * len(tables), 8))
            self._batched = BatchedWindowTable(tables, reserve=reserve)
        else:
            self._batched.restack(tables)

    def detach(self) -> None:
        self._shards = None
        self._slot_map = None
        self._slot_owner = None
        self._batched = None

    def snapshot_barrier(self) -> Dict[str, np.ndarray]:
        """Merge per-shard snapshots into THE canonical snapshot."""
        return merge_shard_snapshots(
            [s.snapshot() for s in self._shards], self._slot_map.table,
            self._slot_map.n_workers,
        )

    # -- observability ---------------------------------------------------------
    def export_health(self, registry) -> None:
        """Publish the live plane's health to a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`: per-shard gauges
        (device-tier occupancy / load factor / probe-distance stats,
        resident vs spill-tier rows) plus the stream-global placement
        counters, read straight off the engine structures."""
        if self._shards is None:
            return
        n_w = len(self._shards)
        registry.gauge("keyed.plane.n_shards").set(n_w)
        healths = (
            self._batched.per_shard_health()
            if self._batched is not None
            else [
                s.table.health() if s.table is not None else None
                for s in self._shards
            ]
        )
        total_resident = 0
        total_spill = 0
        for w, eng in enumerate(self._shards):
            h = healths[w]
            spill_rows = eng.store.num_rows()
            resident = h["occupancy"] if h is not None else 0
            total_resident += resident
            total_spill += spill_rows
            g = registry.gauge
            g(f"keyed.shard{w}.resident_rows").set(resident)
            g(f"keyed.shard{w}.spill_rows").set(spill_rows)
            if h is not None:
                g(f"keyed.shard{w}.occupancy").set(h["occupancy"])
                g(f"keyed.shard{w}.load_factor").set(h["load_factor"])
                g(f"keyed.shard{w}.probe_mean").set(h["probe_mean"])
                g(f"keyed.shard{w}.probe_max").set(h["probe_max"])
        registry.gauge("keyed.plane.resident_rows").set(total_resident)
        registry.gauge("keyed.plane.spill_rows").set(total_spill)
        stats = [
            s.table.stats for s in self._shards if s.table is not None
        ]
        for attr, name in (
            ("inserted", "keyed.table.inserted"),
            ("hits", "keyed.table.hits"),
            ("spilled", "keyed.table.spilled"),
            ("evicted", "keyed.table.evicted"),
        ):
            registry.counter(name).value = sum(
                getattr(st, attr) for st in stats
            )
        registry.counter("keyed.late").value = sum(
            s.late_count for s in self._shards
        )

    # -- per-chunk execution ---------------------------------------------------
    def prepare_chunk(self, chunk) -> Optional[Dict[str, Any]]:
        """State-independent ingest of one chunk — the pipeline stage:
        column extraction, the host-to-device copy and pane expansion,
        depending only on the chunk and the immutable spec."""
        if not (self.has_live_state and self.fused):
            return None
        with self._stage("expand_panes"):
            keys = np.asarray(chunk["key"], np.int64)
            values = np.asarray(chunk["value"], np.int64)
            ts = np.asarray(chunk["ts"], np.int64)
            prep: Dict[str, Any] = {
                "keys": keys, "values": values, "ts": ts,
                # the chunk's max(ts) is the shared watermark clock
                "wm_ts": int(ts.max()) if len(keys) else None,
            }
            if self.spec.kind != "session" and len(keys):
                dev = self.device
                prep["panes"] = expand_panes(
                    self.spec,
                    *(torch.as_tensor(a, device=dev) for a in (keys, values, ts)),
                    torch.arange(len(keys), dtype=torch.int64, device=dev),
                )
            return prep

    def step_live(self, chunk, prepared=None) -> Dict[str, Dict[str, np.ndarray]]:
        """One chunk against the live plane: the fused all-shard pass, or
        the per-shard loop when ``fused=False`` (bit-identical outputs)."""
        if self.fused:
            return self._step_fused(chunk, prepared)
        with self._stage("route"):
            keys = np.asarray(chunk["key"], np.int64)
            if len(keys):
                owners = np.asarray(self._slot_map.table, np.int64)[
                    hash_to_slot(keys, self.num_slots).astype(np.int64)
                ]
                wm_ts = int(np.asarray(chunk["ts"], np.int64).max())
            else:
                owners = np.zeros(0, np.int64)
                wm_ts = None
        em_parts, early_parts, late_parts = [], [], []
        with self._stage("shard_loop", n_shards=len(self._shards)):
            for w, eng in enumerate(self._shards):
                sel = np.flatnonzero(owners == w)
                out = eng.process_chunk(
                    _take(chunk, sel), wm_ts=wm_ts, positions=sel
                )
                em_parts.append(out["emissions"])
                early_parts.append(out["early"])
                late_parts.append(out["late"])
        fire_keys = ("key", "start", "end", "value", "count")
        emissions = _concat_sorted(em_parts, fire_keys)
        early = _concat_sorted(early_parts, fire_keys)
        # late records merge back into stream order by original position
        late_cols = {
            k: np.concatenate([p[k] for p in late_parts])
            for k in ("key", "value", "ts", "start", "pos")
        }
        order = np.argsort(late_cols.pop("pos"), kind="stable")
        late = {k: v[order] for k, v in late_cols.items()}
        return {"emissions": emissions, "late": late, "early": early}

    # -- the fused all-shard pass ----------------------------------------------
    def _step_fused(self, chunk, prep) -> Dict[str, Dict[str, np.ndarray]]:
        """ONE vectorized ingest->update->fire pass for the whole plane:
        routed once, expanded once, deduped once (ownership is a function of
        the key), reduced once, one batched lookup + scatter-add launch,
        one global watermark close.  Bit-identical to the ``fused=False``
        loop and to the serial oracle."""
        if prep is None:
            prep = self.prepare_chunk(chunk)
        keys = prep["keys"]
        wm_ts = prep["wm_ts"]
        if len(keys):
            if self.spec.kind == "session":
                late = self._fused_sessions(prep)
            else:
                late = self._fused_panes(prep)
        else:
            late = _empty_cols(4)
        with self._stage("close"):
            emissions, early = self._fused_advance(
                wm_ts, ticked=bool(len(keys)) or wm_ts is not None
            )
            self._shards[0].late_count += len(late[0])
            if self.spec.late_policy == "side":
                late_out = dict(
                    key=late[0], value=late[1], ts=late[2], start=late[3]
                )
            else:
                z = np.zeros(0, np.int64)
                late_out = dict(key=z, value=z, ts=z, start=z)
        return {"emissions": emissions, "late": late_out, "early": early}

    def _cell_owners(self, cell_keys: torch.Tensor) -> torch.Tensor:
        return self._slot_owner[hash_to_slot(cell_keys, self.num_slots)]

    def _merge_per_shard(self, owners, keys, starts, ends, values, counts):
        """Route host-tier rows (spill / TTL eviction / host backend) to
        their owning shards' stores — one vectorized merge per shard that
        actually received rows."""
        owners = np.asarray(owners, np.int64)
        for w in np.unique(owners).tolist():
            m = owners == w
            self._shards[int(w)]._merge_into_store(
                keys[m], starts[m], ends[m], values[m], counts[m]
            )

    def _fused_panes(self, prep) -> Tuple[np.ndarray, ...]:
        """Tumbling/sliding half of the fused pass; returns the late
        assignment columns ``(key, value, ts, start)`` in stream order."""
        size = self.spec.size
        a_key, a_val, a_ts, _, a_start = prep["panes"]
        late = _empty_cols(4)
        with self._stage("route"):
            wm = self._shards[0].wm  # the shared watermark clock
            if wm is not None:
                late_m = (a_start + size) <= wm
                if bool(late_m.any()):
                    late = to_host((a_key[late_m], a_val[late_m],
                                    a_ts[late_m], a_start[late_m]))
                    live = ~late_m
                    a_key, a_val, a_start = (a_key[live], a_val[live],
                                             a_start[live])
        if len(a_key):
            with self._stage("dedup_cells"):
                cells, inv = kk.dedup_cells(a_key, a_start)
            with self._stage("reduce_by_cell"):
                partial = kk.reduce_by_cell(
                    inv.to(torch.int32),
                    torch.stack([a_val, torch.ones_like(a_val)], dim=1),
                    len(cells), impl=self.impl,
                ).to(torch.int64)
            with self._stage("route"):
                c_keys, c_starts = cells[:, 0], cells[:, 1]
                c_owners = self._cell_owners(c_keys)
                # the §4.2 work tally: one scatter for all shards (the
                # stream-global counters live on shard 0)
                own_h, cnt_h = to_host((c_owners, partial[:, 1]))
                np.add.at(self._shards[0].worker_items, own_h, cnt_h)
            with self._stage("table_update"):
                if self._batched is not None:
                    spill = self._batched.update(
                        c_owners, c_keys, c_starts, c_starts + size,
                        partial[:, 0], partial[:, 1],
                        touch_ts=prep["wm_ts"],
                    )
                    if spill is not None:
                        self._merge_per_shard(*to_host(spill))
                else:
                    self._merge_per_shard(*to_host((
                        c_owners, c_keys, c_starts, c_starts + size,
                        partial[:, 0], partial[:, 1],
                    )))
        return late

    def _fused_sessions(self, prep) -> Tuple[np.ndarray, ...]:
        """Session half of the fused pass: one global sort + fragment
        reduce; the interval merge targets each fragment's owning shard
        store (host-side, as in the reference)."""
        gap = self.spec.gap
        keys, values, ts = prep["keys"], prep["values"], prep["ts"]
        with self._stage("route"):
            wm = self._shards[0].wm
            late_m = (
                (ts + gap) <= wm if wm is not None
                else np.zeros(len(ts), bool)
            )
            live = ~late_m
            k, v, t = keys[live], values[live], ts[live]
        if len(k):
            with self._stage("dedup_cells"):
                frag_ids, vs, frag_keys, frag_lo, frag_hi = \
                    session_fragments(k, v, t, gap)
            with self._stage("reduce_by_cell"):
                sums = reduce_on_device(frag_ids, vs, int(frag_ids[-1]) + 1,
                                        self.impl, self.device)
            with self._stage("route"):
                frag_owners = np.asarray(self._slot_map.table, np.int64)[
                    hash_to_slot(frag_keys, self.num_slots).astype(np.int64)
                ]
                np.add.at(
                    self._shards[0].worker_items, frag_owners, sums[:, 1]
                )
            with self._stage("table_update"):
                for key, lo, hi, ow, (vsum, cnt) in zip(
                    frag_keys.tolist(), frag_lo.tolist(), frag_hi.tolist(),
                    frag_owners.tolist(), sums.tolist(),
                ):
                    merge_session_fragment(
                        self._shards[ow].store, key, lo, hi, vsum, cnt
                    )
        return (keys[late_m], values[late_m], ts[late_m], ts[late_m])

    def _fused_advance(
        self, wm_ts: Optional[int], ticked: bool
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Advance the shared watermark clock on every shard and fire due
        windows ONCE: one batched due-row extraction over the stacked
        planes (plus the host tiers), one global merge into the oracle's
        ``(end, start, key)`` fire order.  TTL eviction is one sweep, the
        owner column routing evicted rows back to their shard's host tier."""
        shards = self._shards
        s0 = shards[0]
        if wm_ts is not None:
            for eng in shards:
                eng.max_ts = (
                    wm_ts if eng.max_ts is None else max(eng.max_ts, wm_ts)
                )
        if s0.max_ts is None:
            return merge_fire(*_empty_cols()), merge_fire(*_empty_cols())
        new_wm = s0.max_ts - self.spec.lateness
        for eng in shards:
            eng.wm = new_wm if eng.wm is None else max(eng.wm, new_wm)
        wm = s0.wm
        parts = [
            # skip shards whose host tier is empty (the common case)
            _rows_to_cols(eng._store_due())
            for eng in shards if any(eng.store.slots)
        ]
        if self._batched is not None:
            parts.append(to_host(self._batched.take_due(wm)[1:6]))
            if self.ttl is not None:
                e = to_host(self._batched.evict_idle(wm, self.ttl)[:6])
                # idle rows change tier, not value: host stores absorb them
                self._merge_per_shard(*e)
        early = merge_fire(*_empty_cols())
        if ticked:
            for eng in shards:
                eng.wm_ticks += 1
            if (
                self.spec.early_every
                and s0.wm_ticks % self.spec.early_every == 0
            ):
                # provisional panes: host tiers walk per shard (usually
                # empty), the device tier is ONE scan of the batched plane
                open_parts = [
                    eng._store_rows() for eng in shards
                    if any(eng.store.slots)
                ]
                if self._batched is not None:
                    open_parts.append(to_host(self._batched.open_rows()))
                early = merge_fire(*_concat_cols(open_parts))
        return merge_fire(*_concat_cols(parts)), early

    def resize_live(self, n_old: int, n_new: int) -> ResizeInfo:
        """Row-level slot migration between live shards: donors extract
        the reassigned slots' rows through the tier masks, recipients
        ``ingest_rows`` them; departing shards fold their counters and work
        tallies into survivors."""
        sm_old = self._slot_map
        sm_new, moved = sm_old.rebalance(n_new)
        old_owner = np.asarray(sm_old.table, np.int64)
        new_owner = np.asarray(sm_new.table, np.int64)
        # grow: fresh shards join with the shared watermark clock and no rows
        proto = self._shards[0]
        while len(self._shards) < n_new:
            eng = KeyedWindowEngine(
                self.spec, num_slots=self.num_slots, **self._engine_kwargs()
            )
            eng.wm, eng.max_ts = proto.wm, proto.max_ts
            eng.wm_ticks = proto.wm_ticks
            self._shards.append(eng)
        if self._batched is not None and n_new > n_old:
            # adopt the fresh shards' empty segments BEFORE the row handoff
            # so the recipients' ingest writes land directly in the plane
            self._batched.restack([s.table for s in self._shards])
        per_recipient: Dict[int, List[Tuple[np.ndarray, ...]]] = {}
        rows_moved = 0
        for d in np.unique(old_owner[moved]).tolist():
            rows = self._shards[int(d)].extract_rows(
                moved[old_owner[moved] == d]
            )
            if not len(rows[0]):
                continue  # empty donor: nothing to bucket or ship
            rows_moved += len(rows[0])
            row_recips = new_owner[
                hash_to_slot(rows[0], self.num_slots).astype(np.int64)
            ]
            for r in np.unique(row_recips).tolist():
                m = row_recips == r
                per_recipient.setdefault(int(r), []).append(
                    tuple(col[m] for col in rows)
                )
        # recipient side: one canonical sorted batch per recipient
        for r in sorted(per_recipient):
            parts = per_recipient[r]
            cols = [np.concatenate([p[i] for p in parts]) for i in range(7)]
            order = np.lexsort((cols[2], cols[1], cols[0]))
            self._shards[r].ingest_rows(*(c[order] for c in cols))
        global_items = np.sum(
            [s.worker_items for s in self._shards[:n_old]], axis=0,
            dtype=np.int64,
        )
        folded = fold_worker_items(global_items, old_owner, new_owner, n_new)
        for eng in self._shards[n_new:]:
            self._shards[0].late_count += eng.late_count
            if self._shards[0].table is not None and eng.table is not None:
                s0, se = self._shards[0].table.stats, eng.table.stats
                s0.inserted += se.inserted
                s0.hits += se.hits
                s0.spilled += se.spilled
                s0.evicted += se.evicted
        del self._shards[n_new:]
        for w, eng in enumerate(self._shards):
            items = np.zeros(n_new, np.int64)
            items[w] = folded[w]
            eng.worker_items = items
            eng.store.slot_map = SlotMap(
                self.num_slots, n_new, table=sm_new.table
            )
        self._set_slot_map(sm_new)
        self._rebuild_batched()
        return ResizeInfo(
            protocol="S2-slotmap-handoff",
            handoff_items=int(len(moved)),
            handoff_rows=int(rows_moved),
            handoff_bytes=int(rows_moved) * ROW_BYTES,
            detail=f"{len(moved)}/{self.num_slots} slots "
                   f"({rows_moved} table rows) migrate "
                   f"(minimal rebalance {n_old}->{n_new})",
        )

    # -- snapshot-per-chunk path (live=False) ----------------------------------
    def make_host_step(self, n_w: int):
        def step(state, chunk):
            eng = KeyedWindowEngine.restore(
                self.spec, state, **self._engine_kwargs()
            )
            if eng.store.n_workers != n_w:
                old_table = eng.store.slot_map.table.copy()
                eng.store.resize(n_w)
                eng.worker_items = fold_worker_items(
                    eng.worker_items, old_table, eng.store.slot_map.table,
                    n_w,
                )
            out = eng.process_chunk(chunk)
            return eng.snapshot(), out

        return step

    def resize(self, state, n_old: int, n_new: int) -> Tuple[Any, ResizeInfo]:
        """Serialized-state resize (detached adapters / ``live=False``):
        rewrites the ownership table and folds worker tallies; the rows do
        not move because the single global store holds them all."""
        table = np.asarray(state["slot_table"], np.int32)
        n_cur = int(state["n_workers"])
        sm, moved = SlotMap(len(table), n_cur, table=table).rebalance(n_new)
        items = fold_worker_items(
            np.asarray(state["worker_items"], np.int64), table, sm.table,
            n_new,
        )
        moved_rows = migrated_rows(state, moved)
        state = dict(
            state, slot_table=sm.table, n_workers=np.int64(n_new),
            worker_items=items,
        )
        return state, ResizeInfo(
            protocol="S2-slotmap-handoff",
            handoff_items=int(len(moved)),
            handoff_rows=int(moved_rows),
            handoff_bytes=int(moved_rows) * ROW_BYTES,
            detail=f"{len(moved)}/{len(table)} slots ({moved_rows} table rows)"
                   f" migrate (minimal rebalance {n_cur}->{n_new})",
        )


def migrated_rows(state, moved_slots) -> int:
    """Open-window rows riding a slot migration: rows (either tier) whose
    key hashes to a slot in ``moved_slots``."""
    keys = np.asarray(state["w_key"], np.int64)
    if not len(keys) or not len(moved_slots):
        return 0
    slots = hash_to_slot(keys, len(np.asarray(state["slot_table"])))
    return int(np.isin(slots.astype(np.int64),
                       np.asarray(moved_slots, np.int64)).sum())
