"""Sharded keyed state store with an explicit slot map (generalized §4.2).

The paper's fully-partitioned pattern hashes every task to a state slot and
gives each slot exactly one owner.  The seed realization used *block*
ownership (``owner = slot // (N / n_w)``), which only admits worker counts
that divide the slot count and forces a resize to move whole blocks.  This
module replaces the implicit block rule with an explicit **slot map** — a
``slot -> owner`` table:

* any worker count ``1 <= n_w <= num_slots`` is valid (ownership is a table,
  not an arithmetic formula);
* a resize migrates **only the reassigned slots**: :meth:`SlotMap.rebalance`
  keeps every surviving worker's slots in place up to its new target share
  and moves the minimum number of slots needed to rebalance — the §4.2
  adaptivity protocol with minimal handoff volume;
* the keyed state itself (:class:`KeyedStore`) groups per-key state by slot,
  so the slot is the unit of both ownership and migration — keyed state and
  window operators over it are the dominant production state classes in
  stream systems, and per-key parallel access with explicit ownership
  transfer is how transactional stream stores scale the same pattern.

``hash_to_slot`` is the store's ``h``: the same multiplicative hash the
serving engine uses for KV-session routing (which is refactored onto this
module — see :func:`plan_relocation`).

Port of ``repro/keyed/store.py``.  The store stays on the host (numpy and
Python dicts), as in the reference: it is the spill tier behind the
device-resident window table.  ``hash_to_slot`` also hashes device tensors,
bit-identically, for the table's ownership masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: Knuth multiplicative hash constant — shared by the keyed store and the
#: serving engine's session router so both realize the same §4.2 ``h``.
HASH_MULTIPLIER = 2654435761


def u64_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x mod n`` where the int64 tensor ``x`` holds uint64 values as their
    two's-complement bit pattern; exact, as int64 in ``[0, n)``.

    Torch has no uint64 remainder on the CPU, and a signed ``%`` gives other
    rows for patterns with the top bit set: for those ``u = x + 2^64``, so
    ``u mod n = (x mod n + 2^64 mod n) mod n`` with a floor ``x mod n``."""
    if not 0 < n < 2 ** 62:
        raise ValueError(f"modulus must be in (0, 2^62), got {n}")
    r = torch.remainder(x, n)
    return torch.where(x < 0, torch.remainder(r + (2 ** 64) % n, n), r)


def hash_to_slot(key, num_slots: int):
    """``h(key) -> [0, num_slots)`` — works on scalars, numpy arrays and
    torch tensors.

    Keys go through int64 first so negative keys wrap into uint64
    deterministically on scalars and arrays alike (a direct uint64 cast
    raises OverflowError for negative Python ints but wraps for arrays).
    numpy inputs give the reference's uint64 array; a tensor gives the same
    values as int64 on its own device (the int64 product wraps modulo 2^64,
    and :func:`u64_mod` takes the unsigned remainder)."""
    if isinstance(key, torch.Tensor):
        return u64_mod(key.to(torch.int64) * HASH_MULTIPLIER, num_slots)
    k = np.asarray(key, dtype=np.int64).astype(np.uint64)
    return (k * np.uint64(HASH_MULTIPLIER)) % np.uint64(num_slots)


def balanced_targets(num_slots: int, n_workers: int) -> np.ndarray:
    """Per-worker slot quota: sizes differ by at most one (floor/ceil split)."""
    base, extra = divmod(num_slots, n_workers)
    return np.asarray(
        [base + (1 if w < extra else 0) for w in range(n_workers)], np.int64
    )


class SlotMap:
    """Explicit ``slot -> owner`` table over ``n_workers`` workers.

    The default table is the balanced contiguous assignment
    ``owner(s) = (s * n_workers) // num_slots`` — it reduces to the paper's
    block distribution whenever ``n_workers`` divides ``num_slots`` and stays
    balanced (counts differ by <= 1) when it does not.
    """

    def __init__(
        self,
        num_slots: int,
        n_workers: int,
        *,
        table: Optional[np.ndarray] = None,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if not 1 <= n_workers <= num_slots:
            raise ValueError(
                f"n_workers must be in [1, num_slots={num_slots}], "
                f"got {n_workers}"
            )
        self.num_slots = num_slots
        self.n_workers = n_workers
        if table is None:
            table = (np.arange(num_slots, dtype=np.int64) * n_workers) \
                // num_slots
        table = np.asarray(table, np.int32)
        if table.shape != (num_slots,):
            raise ValueError(f"table shape {table.shape} != ({num_slots},)")
        if len(table) and (table.min() < 0 or table.max() >= n_workers):
            raise ValueError("table assigns a slot to a nonexistent worker")
        self.table = table

    def owner(self, slot: int) -> int:
        return int(self.table[slot])

    def counts(self) -> np.ndarray:
        """Slots owned per worker, length ``n_workers``."""
        return np.bincount(self.table, minlength=self.n_workers)

    def slots_of(self, worker: int) -> np.ndarray:
        return np.flatnonzero(self.table == worker)

    # -- §4.2 adaptivity: minimal-migration repartition -----------------------
    def rebalance(self, n_new: int) -> Tuple["SlotMap", np.ndarray]:
        """Reassign slots for a new worker count, moving as few as possible.

        Surviving workers (id < ``n_new``) keep their currently-owned slots,
        in slot order, up to their new balanced quota; every other slot
        (owned by a departing worker, or overflow above quota) migrates to
        the under-quota workers in deterministic (slot-order, worker-order)
        fashion.  Returns ``(new_map, moved_slots)`` where ``moved_slots``
        is exactly the set of slots whose owner changed — the §4.2 handoff
        volume is ``len(moved_slots)``.
        """
        if not 1 <= n_new <= self.num_slots:
            raise ValueError(
                f"n_new must be in [1, num_slots={self.num_slots}], "
                f"got {n_new}"
            )
        targets = balanced_targets(self.num_slots, n_new)
        new_table = np.full(self.num_slots, -1, np.int32)
        kept = np.zeros(n_new, np.int64)
        for s in range(self.num_slots):
            w = int(self.table[s])
            if w < n_new and kept[w] < targets[w]:
                new_table[s] = w
                kept[w] += 1
        pool = np.flatnonzero(new_table < 0)
        under = iter(
            w for w in range(n_new) for _ in range(int(targets[w] - kept[w]))
        )
        for s in pool:
            new_table[s] = next(under)
        moved = np.flatnonzero(new_table != self.table)
        return SlotMap(self.num_slots, n_new, table=new_table), moved

    def handoff_volume(self, n_new: int) -> int:
        """Slots that change owner under :meth:`rebalance` to ``n_new``."""
        return int(len(self.rebalance(n_new)[1]))


def fold_worker_items(
    old_items: np.ndarray,
    old_table: np.ndarray,
    new_table: np.ndarray,
    n_new: int,
) -> np.ndarray:
    """Re-own per-worker item tallies across a rebalance, losing nothing.

    Surviving workers keep their own tallies.  A **departing** worker's tally
    follows its slots: it is split over the workers that received them, in
    proportion to the slot counts, integer-rounded by largest remainder
    (ties broken toward the lowest worker id) so the global sum is invariant
    — the fix for shrink resizes silently truncating departed workers'
    tallies out of the §4.2 work-distribution metric.  A departing worker
    that owned no slots (possible only in hand-built tables) folds into
    worker 0.
    """
    old_items = np.asarray(old_items, np.int64)
    old_table = np.asarray(old_table, np.int64)
    new_table = np.asarray(new_table, np.int64)
    items = np.zeros(n_new, np.int64)
    keep = min(n_new, len(old_items))
    items[:keep] = old_items[:keep]
    for d in range(n_new, len(old_items)):
        tally = int(old_items[d])
        if tally == 0:
            continue
        recipients = new_table[old_table == d]
        if not len(recipients):
            items[0] += tally
            continue
        counts = np.bincount(recipients, minlength=n_new)
        total = int(counts.sum())
        shares = tally * counts // total
        remainders = tally * counts - shares * total
        order = np.argsort(-remainders, kind="stable")
        shares[order[: tally - int(shares.sum())]] += 1
        items += shares
    return items


# ---------------------------------------------------------------------------
# keyed store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowState:
    """One open window of one key: ``[start, end)`` with a running aggregate.

    For session windows ``end`` is ``max_ts + gap`` and extends as items
    arrive; for tumbling/sliding windows it is fixed at ``start + size``.
    """

    start: int
    end: int
    value: int
    count: int


class KeyedStore:
    """Per-key windowed state, grouped by hash slot (the migration unit).

    ``slots[s]`` maps ``key -> list[WindowState]`` for every key hashing to
    slot ``s``; the :class:`SlotMap` names the owner of each slot.  All
    mutation helpers keep window lists sorted by ``start`` so snapshots are
    canonical (bit-exact comparable across runs and resizes).
    """

    def __init__(self, num_slots: int, n_workers: int = 1,
                 *, slot_map: Optional[SlotMap] = None):
        self.num_slots = num_slots
        self.slot_map = slot_map or SlotMap(num_slots, n_workers)
        self.slots: List[Dict[int, List[WindowState]]] = [
            {} for _ in range(num_slots)
        ]

    # -- routing ---------------------------------------------------------------
    def slot_of(self, key: int) -> int:
        return int(hash_to_slot(key, self.num_slots))

    def owner_of(self, key: int) -> int:
        return self.slot_map.owner(self.slot_of(key))

    def windows_of(self, key: int) -> List[WindowState]:
        return self.slots[self.slot_of(key)].setdefault(int(key), [])

    # -- §4.2 adaptivity -------------------------------------------------------
    def resize(self, n_new: int) -> np.ndarray:
        """Rebalance ownership onto ``n_new`` workers; per-slot state stays
        in place (the table changes, the data does not) — the migrated-slot
        indices are returned for the runtime's handoff accounting."""
        self.slot_map, moved = self.slot_map.rebalance(n_new)
        return moved

    @property
    def n_workers(self) -> int:
        return self.slot_map.n_workers

    def num_rows(self) -> int:
        """Open windows held in this (host/spill) tier — the gauge the
        observability plane reports as ``spill_rows``."""
        return sum(
            len(wins) for slot in self.slots for wins in slot.values()
        )

    def extract_slot_rows(self, slots) -> List[Tuple[int, int, int, int, int]]:
        """Remove and return every open window of ``slots`` as
        ``(key, start, end, value, count)`` tuples sorted by
        ``(key, start, end)`` — the host tier's half of a row-level slot
        migration (the donor side; :class:`SlotMap` names the recipient)."""
        rows = []
        for s in np.asarray(slots, np.int64).tolist():
            slot_dict = self.slots[int(s)]
            for key, wins in slot_dict.items():
                for w in wins:
                    rows.append((int(key), int(w.start), int(w.end),
                                 int(w.value), int(w.count)))
            slot_dict.clear()
        rows.sort()
        return rows

    # -- checkpoint round-trip (repro_torch.checkpoint-compatible pytree) -----------
    def to_pytree(self) -> Dict[str, np.ndarray]:
        """Flatten to fixed-key numpy arrays (sorted by (key, start): the
        canonical form — identical logical state always serializes
        identically, which is what makes replay/rollback bit-exact)."""
        rows = []
        for slot_dict in self.slots:
            for key, wins in slot_dict.items():
                for w in wins:
                    rows.append((key, w.start, w.end, w.value, w.count))
        rows.sort()
        cols = np.asarray(rows, np.int64).reshape(-1, 5).T
        return {
            "slot_table": self.slot_map.table.copy(),
            "n_workers": np.int64(self.slot_map.n_workers),
            "w_key": cols[0].copy(),
            "w_start": cols[1].copy(),
            "w_end": cols[2].copy(),
            "w_value": cols[3].copy(),
            "w_count": cols[4].copy(),
        }

    @classmethod
    def from_pytree(cls, tree: Dict[str, np.ndarray]) -> "KeyedStore":
        """Rebuild a store from its pytree, **order-canonically**.

        The rows are re-sorted by ``(key, start)`` before insertion rather
        than trusted in array order: the serialized arrays may arrive in any
        order (hand-built trees, concatenated/merged snapshots), and naive
        insertion order leaks into the per-slot dict insertion order and the
        per-key window-list order — the reconstructed store would differ
        from a natively-built one even though the logical state is equal.
        Sorting first makes ``from_pytree(t).to_pytree() == t`` hold for
        every row permutation (regression-tested in tests/test_keyed.py).
        """
        table = np.asarray(tree["slot_table"], np.int32)
        n_workers = int(tree["n_workers"])
        store = cls(
            len(table),
            n_workers,
            slot_map=SlotMap(len(table), n_workers, table=table),
        )
        rows = sorted(
            zip(
                np.asarray(tree["w_key"], np.int64).tolist(),
                np.asarray(tree["w_start"], np.int64).tolist(),
                np.asarray(tree["w_end"], np.int64).tolist(),
                np.asarray(tree["w_value"], np.int64).tolist(),
                np.asarray(tree["w_count"], np.int64).tolist(),
            )
        )
        for key, start, end, value, count in rows:
            store.windows_of(int(key)).append(
                WindowState(int(start), int(end), int(value), int(count))
            )
        return store


# ---------------------------------------------------------------------------
# session-store relocation (the serving engine's resize, as store logic)
# ---------------------------------------------------------------------------

def plan_relocation(
    sessions: Dict[int, int],
    new_num_slots: int,
    *,
    policy: str,
) -> Tuple[Dict[int, int], List[int]]:
    """Plan the §4.2 handoff for a session store resized to ``new_num_slots``.

    ``sessions`` maps occupied slot -> session key, in admission order.
    Returns ``(placements, requeued)``: ``placements`` maps old slot -> new
    slot for every session that survives in place (bit-exact cache copy);
    ``requeued`` lists the old slots whose sessions must be replayed (their
    new slot collided, or no capacity remained).

    * ``policy="hash"`` — re-hash every session key to the new modulus; a
      collision requeues the later session (per-partition order preserved).
    * ``policy="ondemand"`` — keep slot ids that still fit, compact the rest
      into free low slots, requeue the overflow.
    """
    placements: Dict[int, int] = {}
    requeued: List[int] = []
    if policy == "hash":
        for old_slot, key in sessions.items():
            want = int(hash_to_slot(key, new_num_slots))
            if want in placements.values():
                requeued.append(old_slot)
            else:
                placements[old_slot] = want
    elif policy == "ondemand":
        for old_slot in sorted(sessions):
            if old_slot < new_num_slots:
                placements[old_slot] = old_slot
        free_slots = iter(
            s for s in range(new_num_slots) if s not in placements.values()
        )
        for old_slot in sorted(sessions):
            if old_slot >= new_num_slots:
                tgt = next(free_slots, None)
                if tgt is None:
                    requeued.append(old_slot)
                else:
                    placements[old_slot] = tgt
    else:
        raise ValueError(f"unknown relocation policy {policy!r}")
    return placements, requeued
