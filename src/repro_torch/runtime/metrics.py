"""Telemetry bus for the elastic runtime.

Records per-chunk service times, queue depth, resize events, and collector
pressure, and derives the queueing quantities the autoscaler consumes:

* ``t_f_hat`` — EWMA estimate of per-item work, recovered from measured chunk
  service times as ``service * n_w / m`` (the paper's §2 model inverted).
* ``utilization`` — offered load over capacity, ``lambda * t_f_hat / n_w``,
  with the arrival rate measured over a sliding window.
* ``throughput`` — completed items per unit time over the window.

The same quantities cross-check against :mod:`repro_torch.core.analytics`:
``expected_service_time`` is the paper's ``T_s(n_w) = max(t_a, t_f/n_w)``
with the *measured* ``t_f_hat`` plugged in, which is how the elastic
benchmark validates post-resize throughput against the analytic envelope.

Clocks are pluggable so the same bus serves real wall-clock runs and
discrete-event simulations (:class:`LogicalClock` advances only when told);
the clock classes live in :mod:`repro_torch.obs.clock` (re-exported here) so the
tracer and the bus share one implementation.

Memory is **bounded**: the per-record lists (``chunks`` / ``resizes`` /
``depth_samples``) are rolling windows of the newest ``history`` records,
while every aggregate the bus reports — ``summary()``'s chunk/item totals,
``migration_volume()``'s handoff sums, the service-time percentiles — is
maintained cumulatively, so a long-running serving process neither grows
without limit nor loses its lifetime totals.  Service-time percentiles come
from a fixed-bucket log-scale histogram (:class:`repro_torch.obs.metrics.
Histogram`): p50/p95/p99 without storing samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core import analytics
from repro_torch.obs.clock import LogicalClock, WallClock
from repro_torch.obs.metrics import Histogram

__all__ = [
    "ChunkRecord", "LogicalClock", "MetricsBus", "ResizeRecord", "WallClock",
]


@dataclasses.dataclass(frozen=True)
class ChunkRecord:
    t_start: float
    t_end: float
    m: int                 # items in the chunk
    n_workers: int
    queue_depth: int       # depth observed when the chunk was formed
    collector_updates: int = 0  # flush/sync commits in the chunk (S3/S4)

    @property
    def service_time(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass(frozen=True)
class ResizeRecord:
    t: float
    n_old: int
    n_new: int
    protocol: str          # which §4.x transition ran
    handoff_items: int     # S2 slots moved; 0 for S3/S4/S5
    reason: str
    handoff_rows: int = 0   # state rows physically shipped (DMA-path moves)
    handoff_bytes: int = 0  # the same payload in bytes


class MetricsBus:
    def __init__(self, *, clock=None, ewma_alpha: float = 0.3,
                 window: int = 16, history: int = 4096):
        """``window`` bounds the sliding window the derived signals read;
        ``history`` bounds how many raw records the rolling lists retain
        (aggregates are cumulative and unaffected by trimming)."""
        if history < window:
            raise ValueError(
                f"history={history} must be >= window={window}"
            )
        self.clock = clock if clock is not None else WallClock()
        self.chunks: List[ChunkRecord] = []
        self.resizes: List[ResizeRecord] = []
        self.depth_samples: List[int] = []
        self._alpha = ewma_alpha
        self._window = window
        self._history = history
        self._t_f_hat: Optional[float] = None
        # cumulative aggregates: exact over the whole run, however far the
        # rolling record lists have been trimmed
        self._total_chunks = 0
        self._total_items = 0
        self._total_collector_updates = 0
        self._total_resizes = 0
        self._total_handoffs = 0          # resizes that shipped rows
        self._total_handoff_slots = 0
        self._total_handoff_rows = 0
        self._total_handoff_bytes = 0
        #: lifetime chunk-service-time distribution (log-bucket histogram:
        #: p50/p95/p99 without storing samples)
        self.service_hist = Histogram(lo=1e-7, hi=1e4, bins_per_decade=8)

    @staticmethod
    def _trim(lst: List) -> None:
        """Amortized rolling-window trim: drop the oldest half-window at
        once so appends stay O(1) amortized."""
        del lst[: len(lst) // 2]

    # -- recording -----------------------------------------------------------
    def record_chunk(self, rec: ChunkRecord) -> None:
        self.chunks.append(rec)
        if len(self.chunks) > 2 * self._history:
            self._trim(self.chunks)
        self._total_chunks += 1
        self._total_items += rec.m
        self._total_collector_updates += rec.collector_updates
        if rec.service_time > 0:
            self.service_hist.record(rec.service_time)
        if rec.m > 0 and rec.service_time > 0:
            sample = rec.service_time * rec.n_workers / rec.m
            if self._t_f_hat is None:
                self._t_f_hat = sample
            else:
                self._t_f_hat = (
                    self._alpha * sample + (1 - self._alpha) * self._t_f_hat
                )

    def record_resize(self, rec: ResizeRecord) -> None:
        self.resizes.append(rec)
        if len(self.resizes) > 2 * self._history:
            self._trim(self.resizes)
        self._total_resizes += 1
        self._total_handoff_slots += rec.handoff_items
        if rec.handoff_rows > 0:
            self._total_handoffs += 1
            self._total_handoff_rows += rec.handoff_rows
            self._total_handoff_bytes += rec.handoff_bytes

    def record_depth(self, depth: int) -> None:
        self.depth_samples.append(depth)
        if len(self.depth_samples) > 2 * self._history:
            self._trim(self.depth_samples)

    # -- derived signals -----------------------------------------------------
    @property
    def t_f_hat(self) -> Optional[float]:
        """EWMA per-item work estimate (seconds, or simulated units)."""
        return self._t_f_hat

    def _recent(self) -> List[ChunkRecord]:
        return self.chunks[-self._window :]

    def recent_chunks(self, k: Optional[int] = None) -> List[ChunkRecord]:
        """The newest ``min(k, window)`` chunk records — the rolling view
        latency policies plan from (each record carries ``n_workers``, so a
        consumer can degree-normalize across resizes inside the window)."""
        k = self._window if k is None else min(k, self._window)
        return self.chunks[-k:]

    def throughput(self) -> Optional[float]:
        """Completed items per unit time over the window.

        The time base is the **union of the chunk intervals**, not
        ``recent[-1].t_end - recent[0].t_start``: under the double-buffered
        pipeline chunk ``k+1``'s interval overlaps chunk ``k``'s, records
        land in completion order (so the last record need not hold the
        latest ``t_end``), and idle gaps between chunks are not processing
        time — the naive span arithmetic mis-counts all three."""
        recent = self._recent()
        if not recent:
            return None
        ivs = sorted((r.t_start, r.t_end) for r in recent)
        span = 0.0
        cur_s, cur_e = ivs[0]
        for s, e in ivs[1:]:
            if s > cur_e:
                span += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        span += cur_e - cur_s
        if span <= 0:
            return None
        return sum(r.m for r in recent) / span

    def mean_service_time(self) -> Optional[float]:
        recent = self._recent()
        if not recent:
            return None
        return sum(r.service_time for r in recent) / len(recent)

    def utilization(self, arrival_rate: Optional[float] = None) -> Optional[float]:
        """Offered load / capacity at the current degree.

        With no explicit arrival rate, the executor's measured throughput is
        used as a lower bound on the offered load (exact when the queue is
        never empty).
        """
        recent = self._recent()
        if not recent or self._t_f_hat is None:
            return None
        lam = arrival_rate if arrival_rate is not None else self.throughput()
        if lam is None:
            return None
        n_w = recent[-1].n_workers
        return lam * self._t_f_hat / n_w

    def collector_pressure(self) -> Optional[float]:
        """Collector commits per item over the window (paper's Fig. 4 knob:
        high pressure means the flush period is too small for this degree)."""
        recent = self._recent()
        items = sum(r.m for r in recent)
        if not items:
            return None
        return sum(r.collector_updates for r in recent) / items

    def migration_volume(self) -> Dict[str, int]:
        """Aggregate §4.2 handoff payload across all resizes: ownership
        units (slots), physically shipped state rows, and bytes — what the
        migration benchmark gates on (resize cost must scale with rows
        moved, not with standing state).  ``handoffs`` counts only the
        resizes that physically shipped rows: a resize over an empty plane
        (or one whose moved slots hold no open windows) is a metadata-only
        transition and must not read as a DMA-path handoff.  Sums are
        cumulative over the whole run — they survive the rolling-window
        trim of ``self.resizes``."""
        return {
            "resizes": self._total_resizes,
            "handoffs": self._total_handoffs,
            "slots": self._total_handoff_slots,
            "rows": self._total_handoff_rows,
            "bytes": self._total_handoff_bytes,
        }

    def resize_timeline(self) -> List[Dict[str, Any]]:
        """The retained resize events as a flat timeline (one dict per
        event, same payload accounting as :meth:`migration_volume`) — what
        the trace export renders as instant events and the report renderer
        tables."""
        return [
            {
                "t": r.t, "n_old": r.n_old, "n_new": r.n_new,
                "protocol": r.protocol, "slots": r.handoff_items,
                "rows": r.handoff_rows, "bytes": r.handoff_bytes,
                "reason": r.reason,
            }
            for r in self.resizes
        ]

    def percentiles(self) -> Dict[str, Optional[float]]:
        """Lifetime chunk-service-time p50/p95/p99 (from the log-bucket
        histogram — no samples stored)."""
        return self.service_hist.percentiles()

    def expected_service_time(self, n_w: int, t_a: float = 0.0) -> Optional[float]:
        """Paper §2 ``T_s(n_w)`` with the measured ``t_f_hat``: the analytic
        cross-check for what a resize to ``n_w`` should deliver."""
        if self._t_f_hat is None:
            return None
        # t_f_hat is per-item work for ONE worker; a chunk of m items on n_w
        # workers ideally takes m/n_w * t_f_hat.
        return analytics.service_time(t_a, self._t_f_hat, n_w)

    def summary(self) -> Dict[str, Any]:
        recent = self._recent()
        pct = self.percentiles()
        return {
            "chunks": self._total_chunks,
            "items": self._total_items,
            "degree": recent[-1].n_workers if recent else None,
            "queue_depth": self.depth_samples[-1] if self.depth_samples else 0,
            "throughput": self.throughput(),
            "mean_service_time": self.mean_service_time(),
            "service_p50": pct["p50"],
            "service_p95": pct["p95"],
            "service_p99": pct["p99"],
            "t_f_hat": self._t_f_hat,
            "utilization": self.utilization(),
            "collector_pressure": self.collector_pressure(),
            "resizes": self._total_resizes,
            "migration": self.migration_volume(),
        }
