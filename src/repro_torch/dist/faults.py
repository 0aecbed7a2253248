"""Deterministic seeded fault injection for the distributed keyed plane.

A copy of ``repro/dist/faults.py``: ``FaultPlan.storm(seed, ...)`` draws
the reference's faults for the same seed (``tests/test_torch_wire.py``).

A :class:`FaultPlan` arms :class:`Fault` records at **named protocol
points**; the plane and the shard hosts consult the plan at each point and
apply whatever fires.  Every fault is deterministic — selected by a seeded
occurrence count, never a wall-clock race — so a chaos run is replayable
bit-for-bit and CI can gate on it.

Protocol points are ``(site, op)`` pairs where ``op`` is an RKWP frame
name (``"STEP"``, ``"EXTRACT"``, ...) and ``site`` is where in the frame's
life the fault strikes:

``send``
    Coordinator-side, as the request leaves: ``drop`` (never transmitted),
    ``corrupt`` (one byte flipped in the encoded frame), ``truncate``
    (frame cut short), ``delay`` (sleep before a normal send).  These
    exercise the worker's NACK/resync path and the coordinator's
    retransmit machinery.

``worker``
    Worker-side, *before* the matching handler runs: ``hang`` (sleep past
    any deadline — the liveness-probe kill path), ``slow`` (sleep
    ``seconds`` then proceed — the slow-worker soft signal), ``crash``
    (black-box dump + hard exit — the warm-spare/Supervisor path).

``reply``
    Worker-side, *after* the handler ran, on the reply: ``drop`` (reply
    computed + cached but never sent — forces probe + retransmit, served
    from the reply cache, proving exactly-once), ``corrupt`` (reply bytes
    flipped in flight), ``delay`` (sleep ``seconds`` before sending).

``shm``
    Worker-side: one byte of the reply's shared-memory span flipped after
    its descriptor CRC is computed (a corrupted ring slot).  Inert on the
    pipe transport.

Faults with sites other than ``send`` ship to the workers in FAULT frames
at attach time; each side counts matching occurrences locally and fires a
fault exactly once, on its ``nth`` occurrence.  Kill-faults (``hang``,
``crash``) are consumed by the coordinator on death attribution so a
Supervisor-recovered plane does not re-arm them into an infinite
kill/restore loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

#: valid kinds per site (validated at plan construction)
SITE_KINDS = {
    "send": ("drop", "corrupt", "truncate", "delay"),
    "worker": ("hang", "slow", "crash"),
    "reply": ("drop", "corrupt", "delay"),
    "shm": ("corrupt",),
}

#: sites applied by the worker (shipped via FAULT frames)
WORKER_SITES = ("worker", "reply", "shm")


@dataclasses.dataclass
class Fault:
    """One armed fault.  ``shard=None`` matches any shard; ``nth`` is the
    1-based matching occurrence on which the fault fires (then it is spent).
    ``seconds`` parameterizes ``delay``/``slow``; ``seed`` picks the flipped
    byte for ``corrupt``/``truncate``."""

    site: str
    op: str
    kind: str
    nth: int = 1
    shard: Optional[int] = None
    seconds: float = 0.05
    seed: int = 0
    id: int = -1  # assigned by the owning plan

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "Fault":
        return cls(**{k: d[k] for k in
                      ("site", "op", "kind", "nth", "shard", "seconds",
                       "seed", "id")})


class FaultMatcher:
    """Occurrence-counting matcher over a fault list — the shared engine
    behind both the coordinator's plan and the worker's armed copy.

    ``draw(site, op, shard)`` increments the occurrence count of every
    live fault whose selector matches and returns the first one that just
    reached its ``nth`` occurrence (marking it spent)."""

    def __init__(self, faults: Sequence[Fault]):
        self.faults = list(faults)
        self._seen: Dict[int, int] = {f.id: 0 for f in self.faults}
        self.spent: set = set()
        self.fired: List[Dict] = []

    def draw(self, site: str, op: str, shard: Optional[int] = None
             ) -> Optional[Fault]:
        hit = None
        for f in self.faults:
            if f.id in self.spent or f.site != site or f.op != op:
                continue
            if f.shard is not None and shard is not None and f.shard != shard:
                continue
            self._seen[f.id] += 1
            if hit is None and self._seen[f.id] == f.nth:
                self.spent.add(f.id)
                self.fired.append(
                    {"id": f.id, "site": site, "op": op, "kind": f.kind,
                     "shard": shard}
                )
                hit = f
        return hit


class FaultPlan(FaultMatcher):
    """The coordinator's fault schedule.

    The plane draws ``send``-site faults itself and ships the rest to the
    workers (:meth:`worker_faults`) in FAULT frames at attach time.  When a
    worker dies, :meth:`consume_kill` attributes the death to the armed
    kill-fault that caused it so re-attach after Supervisor recovery does
    not re-arm it.
    """

    def __init__(self, faults: Iterable[Fault] = (), seed: int = 0):
        faults = list(faults)
        for i, f in enumerate(faults):
            if f.site not in SITE_KINDS:
                raise ValueError(f"unknown fault site {f.site!r}")
            if f.kind not in SITE_KINDS[f.site]:
                raise ValueError(
                    f"kind {f.kind!r} invalid at site {f.site!r} "
                    f"(valid: {SITE_KINDS[f.site]})"
                )
            if f.nth < 1:
                raise ValueError(f"nth must be >= 1, got {f.nth}")
            f.id = i
        super().__init__(faults)
        self.seed = seed

    # -- worker shipping -------------------------------------------------------
    def worker_faults(self) -> List[Dict]:
        """Serialized faults for the FAULT frame: worker-applied sites only,
        minus anything already spent (coordinator-attributed kills)."""
        return [f.to_dict() for f in self.faults
                if f.site in WORKER_SITES and f.id not in self.spent]

    def consume_kill(self, cause: str, shards: Iterable[int]) -> None:
        """Attribute a worker death to its armed kill-fault.  ``hung``
        deaths consume a ``hang``; ``dead`` deaths consume a ``crash``
        (hard exit and EOF are indistinguishable from outside).  Only
        faults scoped to the dead host's shards are eligible."""
        kind = {"hung": "hang", "dead": "crash"}.get(cause)
        if kind is None:
            return
        shard_set = set(shards)
        for f in self.faults:
            if f.id in self.spent or f.kind != kind:
                continue
            if f.shard is not None and f.shard not in shard_set:
                continue
            self.spent.add(f.id)
            self.fired.append(
                {"id": f.id, "site": f.site, "op": f.op, "kind": f.kind,
                 "shard": f.shard, "attributed": cause}
            )
            return

    def kinds_fired(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.fired:
            key = f"{rec['site']}:{rec['kind']}"
            out[key] = out.get(key, 0) + 1
        return out

    # -- storm generator -------------------------------------------------------
    @classmethod
    def storm(cls, seed: int, *, n_shards: int, n_chunks: int,
              delay_s: float = 0.05, include_kills: bool = True,
              include_shm: bool = True, migrate_ops: bool = False
              ) -> "FaultPlan":
        """A seeded chaos schedule covering every fault family at least
        once: hang, crash, frame corruption (both directions), truncation,
        dropped frames (both directions), delayed request + delayed reply,
        and an shm slot corruption.  Deterministic in ``seed``; sized for a
        run of ``n_chunks`` chunks over ``n_shards`` shards.

        Kill-faults are scoped one per (shard, kind) so death attribution
        (:meth:`consume_kill`) is unambiguous, and are placed in the first
        half of the run so recovery replay still has chunks left to prove
        itself on.
        """
        rng = np.random.RandomState(seed)

        def occ(lo: float, hi: float) -> int:
            # an occurrence index within [lo, hi) of the per-shard STEP count
            return int(rng.randint(max(1, int(n_chunks * lo)),
                                   max(2, int(n_chunks * hi))))

        faults = [
            # transport faults: recoverable, retried transparently
            Fault("send", "STEP", "corrupt", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards)), seed=int(rng.randint(1 << 30))),
            Fault("send", "STEP", "truncate", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards)), seed=int(rng.randint(1 << 30))),
            Fault("send", "STEP", "drop", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards))),
            Fault("send", "STEP", "delay", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards)), seconds=delay_s),
            Fault("reply", "STEP", "corrupt", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards)), seed=int(rng.randint(1 << 30))),
            Fault("reply", "STEP", "drop", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards))),
            Fault("reply", "STEP", "delay", nth=occ(0.05, 0.9),
                  shard=int(rng.randint(n_shards)), seconds=delay_s),
        ]
        if include_shm:
            faults.append(
                Fault("shm", "STEP", "corrupt", nth=occ(0.05, 0.9),
                      shard=int(rng.randint(n_shards)))
            )
        if include_kills:
            # distinct shards, first half of the run (see docstring)
            kill_shards = rng.permutation(n_shards)[:2]
            faults.append(Fault("worker", "STEP", "hang",
                                nth=occ(0.1, 0.45), shard=int(kill_shards[0])))
            faults.append(Fault("worker", "STEP", "crash",
                                nth=occ(0.1, 0.45),
                                shard=int(kill_shards[-1])))
        if migrate_ops:
            faults.append(Fault("worker", "EXTRACT", "crash", nth=1,
                                shard=None))
        return cls(faults, seed=seed)
