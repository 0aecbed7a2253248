"""Stream front-end of the elastic runtime: sources, arrival models,
backpressure queue, and the SPMD chunker.

The paper (§2) models the farm's input as an unbounded stream whose items
"arrive at different times".  This module makes that concrete for a
long-running runtime:

* :class:`ArrivalModel` subclasses turn a logical tick into an arrival count
  (constant, Poisson, bursty, sinusoidal) — all seeded/deterministic so runs
  are reproducible and resize tests are bit-exact.
* Sources (:class:`BoundedSource`, :class:`SyntheticSource`) produce the item
  payloads; a source is just a cursor into a deterministic item function, so
  any chunk can be regenerated after a failure (same idea as
  :mod:`repro_torch.data.pipeline`).
* :class:`BackpressureQueue` decouples arrivals from the SPMD execution rate
  and is the autoscaler's primary signal: depth, watermarks, and
  time-above-high-watermark are all accounted.
* :class:`Chunker` shapes queued items into fixed-size chunks the SPMD
  executor can shard evenly over the current worker axis.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# arrival models
# ---------------------------------------------------------------------------

class ArrivalModel:
    """Items arriving during logical tick ``t`` (deterministic per seed)."""

    def arrivals(self, t: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class ConstantRate(ArrivalModel):
    items_per_tick: int

    def arrivals(self, t: int) -> int:
        return self.items_per_tick


@dataclasses.dataclass
class PoissonRate(ArrivalModel):
    """Poisson arrivals with mean ``lam`` per tick (seeded, reproducible)."""

    lam: float
    seed: int = 0

    def arrivals(self, t: int) -> int:
        rng = np.random.default_rng(np.uint64(self.seed * 1_000_003 + t))
        return int(rng.poisson(self.lam))


@dataclasses.dataclass
class BurstyRate(ArrivalModel):
    """``base`` arrivals per tick, jumping to ``burst`` for the first
    ``duty`` ticks of every ``period`` — the load step the autoscaler has to
    track (paper's changing-throughput scenario)."""

    base: int
    burst: int
    period: int
    duty: int

    def arrivals(self, t: int) -> int:
        return self.burst if (t % self.period) < self.duty else self.base


@dataclasses.dataclass
class SinusoidRate(ArrivalModel):
    """Smooth diurnal-style load: mean ± amplitude over ``period`` ticks."""

    mean: float
    amplitude: float
    period: int

    def arrivals(self, t: int) -> int:
        x = self.mean + self.amplitude * math.sin(2 * math.pi * t / self.period)
        return max(0, int(round(x)))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class Source:
    """A cursor over a deterministic item sequence.

    ``take(k)`` returns up to ``k`` items as a stacked numpy array (fewer only
    at end-of-stream) and advances the cursor; ``exhausted`` reports stream
    end.  Determinism in ``position`` is what makes failure replay and elastic
    repartitioning data-movement-free (the cursor is the whole stream state).
    """

    def take(self, k: int) -> np.ndarray:
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        raise NotImplementedError

    @property
    def position(self) -> int:
        raise NotImplementedError

    def seek(self, position: int) -> None:
        raise NotImplementedError


class BoundedSource(Source):
    """Finite stream over a materialized array (tests, benchmarks)."""

    def __init__(self, items: np.ndarray):
        self._items = np.asarray(items)
        self._pos = 0

    def take(self, k: int) -> np.ndarray:
        out = self._items[self._pos : self._pos + k]
        self._pos += len(out)
        return out

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._items)

    @property
    def position(self) -> int:
        return self._pos

    def seek(self, position: int) -> None:
        if not 0 <= position <= len(self._items):
            raise ValueError(f"seek({position}) outside [0, {len(self._items)}]")
        self._pos = position


class SyntheticSource(Source):
    """Unbounded stream: item ``i`` is ``item_fn(i)`` (pure, regenerable)."""

    def __init__(self, item_fn, total: Optional[int] = None):
        self._fn = item_fn
        self._total = total
        self._pos = 0

    def take(self, k: int):
        if self._total is not None:
            k = min(k, self._total - self._pos)
        items = [self._fn(self._pos + i) for i in range(k)]
        self._pos += k
        if not items:
            return []
        if isinstance(items[0], (np.ndarray, int, float, np.number)):
            return np.stack([np.asarray(x) for x in items])
        return items  # arbitrary objects (e.g. serving requests)

    @property
    def exhausted(self) -> bool:
        return self._total is not None and self._pos >= self._total

    @property
    def position(self) -> int:
        return self._pos

    def seek(self, position: int) -> None:
        self._pos = position


# ---------------------------------------------------------------------------
# backpressure queue
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QueueStats:
    offered: int = 0            # items the source attempted to enqueue
    accepted: int = 0           # items actually enqueued
    taken: int = 0              # items handed to the executor
    peak_depth: int = 0
    ticks_above_high: int = 0   # autoscaler pressure signal
    ticks_below_low: int = 0


class BackpressureQueue:
    """Bounded FIFO between arrivals and the SPMD executor.

    ``offer`` accepts at most the remaining capacity and reports how many
    items were admitted — the source is expected to hold back the rest
    (backpressure rather than drop: the runtime never loses or reorders
    tasks).  Watermark crossings are tallied per observation for the
    autoscaler's queue-depth policy.
    """

    def __init__(
        self,
        capacity: int,
        *,
        high_watermark: Optional[int] = None,
        low_watermark: int = 0,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.high_watermark = (
            high_watermark if high_watermark is not None else (3 * capacity) // 4
        )
        self.low_watermark = low_watermark
        self._items: Deque[np.ndarray] = collections.deque()
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._items)

    @property
    def depth(self) -> int:
        return len(self._items)

    def offer(self, items: np.ndarray) -> int:
        """Enqueue up to capacity; returns number accepted."""
        self.stats.offered += len(items)
        room = self.capacity - len(self._items)
        n = min(room, len(items))
        for i in range(n):
            self._items.append(items[i])
        self.stats.accepted += n
        self.stats.peak_depth = max(self.stats.peak_depth, len(self._items))
        return n

    def take(self, k: int) -> List:
        """Dequeue exactly ``min(k, depth)`` items, FIFO, as a list (callers
        that need an array stack it — items may be arbitrary objects, e.g.
        serving requests)."""
        n = min(k, len(self._items))
        out = [self._items.popleft() for _ in range(n)]
        self.stats.taken += n
        return out

    def observe(self) -> int:
        """Record one watermark observation; returns current depth."""
        d = len(self._items)
        if d >= self.high_watermark:
            self.stats.ticks_above_high += 1
        elif d <= self.low_watermark:
            self.stats.ticks_below_low += 1
        return d


# ---------------------------------------------------------------------------
# chunker
# ---------------------------------------------------------------------------

class Chunker:
    """Shape queued items into SPMD-sized chunks.

    ``chunk_size`` is fixed across the run and must be divisible by every
    parallelism degree the autoscaler may select (times the pattern's
    per-worker granularity, e.g. the S3 flush period) — the executor
    validates this per degree.  A fixed chunk size means a resize never
    changes *what* a chunk is, only how it is sharded, which is what makes
    mid-stream resizes bit-exact against a fixed-degree run.
    """

    def __init__(self, chunk_size: int):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = chunk_size

    @staticmethod
    def _shape(items: List):
        if items and isinstance(items[0], np.void):
            # structured records (e.g. keyed stream items): re-stack into a
            # record array so field access stays columnar downstream
            return np.array(items, dtype=items[0].dtype)
        if items and isinstance(items[0], np.ndarray):
            return np.stack(items)
        if items and np.isscalar(items[0]):
            return np.asarray(items)
        return items  # arbitrary objects (e.g. serving requests)

    def ready(self, queue: BackpressureQueue) -> bool:
        return queue.depth >= self.chunk_size

    def next_chunk(self, queue: BackpressureQueue):
        if not self.ready(queue):
            return None
        return self._shape(queue.take(self.chunk_size))

    def drain_tail(self, queue: BackpressureQueue):
        """End-of-stream: return the final partial chunk (may need a
        degree/granularity fallback — the executor handles that)."""
        if queue.depth == 0:
            return None
        return self._shape(queue.take(queue.depth))


def pump(
    source: Source,
    model: ArrivalModel,
    queue: BackpressureQueue,
    t: int,
    *,
    pending: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Advance one logical tick: draw arrivals from the model, pull that many
    items from the source, and offer them (after any backpressured leftovers)
    to the queue.  Returns the new leftover batch (items the queue refused),
    which the caller must re-offer before new arrivals — preserving order.
    """
    batches: List[np.ndarray] = []
    if pending is not None and len(pending):
        batches.append(pending)
    n = model.arrivals(t)
    if n > 0 and not source.exhausted:
        fresh = source.take(n)
        if len(fresh):
            batches.append(fresh)
    leftover: List = []
    for b in batches:
        if leftover:  # earlier batch already blocked: keep order
            leftover.append(b)
            continue
        accepted = queue.offer(b)
        if accepted < len(b):
            leftover.append(b[accepted:])
    if not leftover:
        return None
    if len(leftover) == 1:
        return leftover[0]
    if isinstance(leftover[0], np.ndarray):
        return np.concatenate(leftover)
    return [x for b in leftover for x in b]
