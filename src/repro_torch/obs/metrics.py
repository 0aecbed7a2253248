"""Metrics registry: counters, gauges, and fixed-bucket log-scale histograms.

The histogram is the piece the scaling ROADMAP items need: **latency
percentiles without storing samples**.  Buckets are fixed at construction on
a log-10 grid (``bins_per_decade`` buckets per decade between ``lo`` and
``hi``), a sample is one integer increment, and ``percentile(q)``
interpolates geometrically inside the owning bucket — so p50/p95/p99 over a
million-chunk run cost a few hundred ints of memory and are deterministic
functions of the recorded multiset.  Exact ``count / total / min / max``
ride along so the tails are never bucket-quantized away.

:class:`MetricsRegistry` is the flat namespace the runtime exports:
``registry.counter("keyed.spilled")``, ``registry.gauge(
"keyed.shard3.occupancy")``, ``registry.histogram("chunk.service_s")`` —
``snapshot()`` renders everything to one JSON-able dict (the
metrics-snapshot artifact CI uploads next to the trace).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional

import numpy as np


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (occupancy, depth, fraction)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket log-scale histogram with interpolated percentiles.

    Bucket ``i`` (``1 <= i <= n``) covers ``[edge(i-1), edge(i))`` with
    ``edge(j) = lo * 10**(j / bins_per_decade)``; bucket 0 is the underflow
    (``v < lo``, including non-positive samples) and bucket ``n+1`` the
    overflow.  ``percentile`` resolves under/overflow to the exact recorded
    min/max, so degenerate distributions (all-equal, all-below-range) come
    back exact rather than bucket-rounded.
    """

    __slots__ = ("lo", "hi", "bins_per_decade", "_scale", "counts", "count",
                 "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 bins_per_decade: int = 8):
        if not 0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo}, hi={hi}")
        if bins_per_decade < 1:
            raise ValueError(f"bins_per_decade must be >= 1, got {bins_per_decade}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = bins_per_decade
        self._scale = bins_per_decade / math.log(10.0)
        n = int(math.ceil(math.log(hi / lo) * self._scale))
        self.counts = [0] * (n + 2)          # [underflow] + n buckets + [overflow]
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def _edge(self, j: int) -> float:
        return self.lo * 10.0 ** (j / self.bins_per_decade)

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v < self.lo:
            self.counts[0] += 1
            return
        idx = 1 + int(math.log(v / self.lo) * self._scale)
        if idx >= len(self.counts) - 1:
            self.counts[-1] += 1
        else:
            self.counts[idx] += 1

    def record_many(self, values) -> None:
        """Vectorized :meth:`record` for the hot path: one ``log`` + one
        ``bincount`` over the whole batch instead of a Python loop.  Produces
        bit-identical state to recording each value individually."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        self.count += int(v.size)
        self.total += float(v.sum())
        vmin, vmax = float(v.min()), float(v.max())
        if self.min is None or vmin < self.min:
            self.min = vmin
        if self.max is None or vmax > self.max:
            self.max = vmax
        under = v < self.lo
        idx = np.zeros(v.shape, dtype=np.int64)
        ok = ~under
        if ok.any():
            idx[ok] = 1 + (np.log(v[ok] / self.lo) * self._scale).astype(np.int64)
        idx = np.minimum(idx, len(self.counts) - 1)
        binned = np.bincount(idx, minlength=len(self.counts))
        for i in np.nonzero(binned)[0]:
            self.counts[i] += int(binned[i])

    @property
    def underflow(self) -> int:
        """Samples below ``lo`` (kept in their own bin, not clamped)."""
        return self.counts[0]

    @property
    def overflow(self) -> int:
        """Samples at or above ``hi`` (kept in their own bin, not clamped)."""
        return self.counts[-1]

    def percentile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` in [0, 1] (None while empty)."""
        if not self.count:
            return None
        if not 0 <= q <= 1:
            raise ValueError(f"q must be in [0, 1], got {q}")
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                if i == 0:                       # underflow: exact floor
                    return self.min
                if i == len(self.counts) - 1:    # overflow: exact ceiling
                    return self.max
                lo, hi = self._edge(i - 1), self._edge(i)
                frac = (rank - seen) / c
                # geometric interpolation matches the log-spaced grid
                v = lo * (hi / lo) ** frac
                # exact tails beat bucket edges for extreme quantiles
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {
            "count": self.count, "total": self.total, "mean": self.mean,
            "min": self.min, "max": self.max,
            "underflow": self.underflow, "overflow": self.overflow,
            **self.percentiles(),
        }


class MetricsRegistry:
    """Flat name -> instrument namespace with get-or-create accessors."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kwargs) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(**kwargs)
        return h

    def snapshot(self) -> Dict[str, Dict]:
        """One JSON-able dict of everything registered."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.snapshot() for k, h in sorted(self._histograms.items())
            },
        }

    def write(self, path: str) -> None:
        """The flat metrics-snapshot artifact (CI uploads these)."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")
