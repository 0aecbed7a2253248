"""Online per-stage regression detection over a tracer's span stream.

Port of ``repro/obs/detect.py`` (pure Python, the same arithmetic).  The
spans it reads are host-clock spans; the port's keyed adapter synchronizes
the card before a stage span closes whenever its tracer is enabled, so a
stage's duration covers its device work, not only its launches.

The fused keyed plane traces every chunk as one anchor span (``chunk``)
containing the six fixed stage spans (``route`` / ``expand_panes`` /
``dedup_cells`` / ``reduce_by_cell`` / ``table_update`` / ``close`` —
:data:`repro_torch.keyed.runtime.FUSED_STAGES`).  The detector maintains a
**rolling robust baseline** (median / MAD over a bounded window) for the
anchor and for each stage's per-chunk total, and when a chunk's duration
breaches its baseline it **attributes** the breach via the span tree: among
the stage spans timestamp-contained in that anchor (same thread), the one
with the largest robust z-score that itself breaches is responsible.

Robust z uses ``1.4826 * MAD`` as sigma (the normal-consistent scale), with
a relative floor so noise-free baselines (logical clocks, quantized timers)
don't make every wobble infinitely significant.  Both the z-score *and* a
multiplicative factor must exceed their thresholds — a stage that is 3
sigma slower but only 1.05x slower is jitter, not a regression.

Detection is incremental — :meth:`RegressionDetector.consume` reads only
spans appended since the last call, so calling it once per chunk (or once
per thousand) costs the same total work.  Flagged regressions are appended
to ``regressions``, emitted as ``detect.regression`` instants on the same
tracer (the annotation lands in the same trace next to the slow spans), and
counted in an optional registry (``obs.detect.regressions``).

Attribution scope: stage spans **inside** the anchor span, i.e. the chunk's
critical path.  With the double-buffered pipeline on, ``expand_panes`` runs
overlapped on the prepare thread — outside every anchor — and is deliberately
not attributed: overlapped work is not chunk latency.

Baselines keep updating through a regression, so a sustained slowdown is
flagged immediately and then absorbed as the new normal within one window —
rolling baselines detect *changes*, not absolute levels (that is the SLO
tracker's job, :mod:`repro_torch.obs.slo`).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

#: MAD -> sigma for a normal distribution
_MAD_SIGMA = 1.4826


def _median(sorted_xs: List[float]) -> float:
    n = len(sorted_xs)
    mid = n // 2
    if n % 2:
        return sorted_xs[mid]
    return 0.5 * (sorted_xs[mid - 1] + sorted_xs[mid])


class StageBaseline:
    """Rolling median/MAD duration baseline over a bounded window."""

    __slots__ = ("window", "min_samples", "durations", "rel_floor")

    def __init__(self, window: int = 64, min_samples: int = 8,
                 rel_floor: float = 0.05):
        self.window = window
        self.min_samples = min_samples
        self.rel_floor = rel_floor   # sigma floor as a fraction of the median
        self.durations: Deque[float] = deque(maxlen=window)

    def add(self, d: float) -> None:
        self.durations.append(d)

    @property
    def ready(self) -> bool:
        return len(self.durations) >= self.min_samples

    def median(self) -> float:
        return _median(sorted(self.durations))

    def mad(self) -> float:
        med = self.median()
        return _median(sorted(abs(d - med) for d in self.durations))

    def sigma(self) -> float:
        """Robust scale: ``1.4826 * MAD`` floored at ``rel_floor * median``
        so quantization-flat baselines don't produce infinite z-scores."""
        med = self.median()
        return max(_MAD_SIGMA * self.mad(), self.rel_floor * med, 1e-12)

    def score(self, d: float) -> Tuple[float, float]:
        """``(robust z, multiplicative factor)`` of one new duration."""
        med = self.median()
        z = (d - med) / self.sigma()
        factor = d / med if med > 0 else float("inf")
        return z, factor


@dataclasses.dataclass(frozen=True)
class StageRegression:
    """One attributed chunk-level breach."""

    chunk: int                       # anchor ordinal (0 = first anchor seen)
    stage: Optional[str]             # responsible stage (None: unattributed)
    anchor_duration: float
    anchor_baseline: float
    anchor_z: float
    anchor_factor: float
    stage_duration: float
    stage_baseline: float
    stage_z: float
    stage_factor: float


class RegressionDetector:
    """Consume a tracer's span stream; flag and attribute chunk breaches.

    ``stages=None`` tracks every span name nested in the anchor; pass
    :data:`repro_torch.keyed.runtime.FUSED_STAGES` to pin the keyed plane's six.
    """

    def __init__(self, tracer, *, anchor: str = "chunk",
                 stages: Optional[Tuple[str, ...]] = None,
                 window: int = 64, min_samples: int = 8,
                 z_threshold: float = 6.0, min_factor: float = 1.5,
                 registry=None):
        if not 0 < min_samples <= window:
            raise ValueError("need 0 < min_samples <= window, got "
                             f"{min_samples} / {window}")
        self.tracer = tracer
        self.anchor = anchor
        self.stages = tuple(stages) if stages is not None else None
        self.window = window
        self.min_samples = min_samples
        self.z_threshold = z_threshold
        self.min_factor = min_factor
        self.registry = registry
        self.baselines: Dict[str, StageBaseline] = {}
        self.regressions: List[StageRegression] = []
        self.chunks_seen = 0
        self._cursor = 0             # index into tracer.spans
        self._pending: Dict[int, List] = {}   # tid -> stage spans not yet owned

    def baseline(self, name: str) -> StageBaseline:
        b = self.baselines.get(name)
        if b is None:
            b = self.baselines[name] = StageBaseline(
                self.window, self.min_samples)
        return b

    # -- ingestion -----------------------------------------------------------
    def consume(self) -> List[StageRegression]:
        """Process spans appended since the last call; return new flags."""
        spans = self.tracer.spans
        new = spans[self._cursor:]
        self._cursor += len(new)
        out: List[StageRegression] = []
        for s in new:
            if s.name == self.anchor:
                reg = self._close_chunk(s)
                if reg is not None:
                    out.append(reg)
            elif self.stages is None or s.name in self.stages:
                self._pending.setdefault(s.tid, []).append(s)
        return out

    def _close_chunk(self, a) -> Optional[StageRegression]:
        """An anchor span finished: gather its contained stage spans (spans
        are recorded at exit, so children always precede their anchor in the
        buffer), score, attribute, update baselines."""
        totals: Dict[str, float] = {}
        mine = self._pending.get(a.tid, [])
        keep = []
        for s in mine:
            if s.t0 >= a.t0 and s.t1 <= a.t1:
                totals[s.name] = totals.get(s.name, 0.0) + s.duration
            elif s.t1 > a.t1:
                keep.append(s)       # belongs to a later anchor on this tid
        self._pending[a.tid] = keep
        # bound other tids' pendings: spans that ended before this anchor
        # began can never be contained in a future anchor
        for tid, buf in self._pending.items():
            if tid != a.tid:
                self._pending[tid] = [s for s in buf if s.t1 >= a.t0]

        chunk = self.chunks_seen
        self.chunks_seen += 1
        dur = a.duration
        ab = self.baseline(self.anchor)
        reg = None
        if ab.ready:
            z, factor = ab.score(dur)
            if z > self.z_threshold and factor > self.min_factor:
                reg = self._attribute(chunk, dur, ab, z, factor, totals)
                self.regressions.append(reg)
                self.tracer.instant(
                    "detect.regression", chunk=chunk,
                    stage=reg.stage or "(unattributed)",
                    factor=reg.stage_factor, z=reg.stage_z,
                    anchor_factor=factor, anchor_z=z,
                )
                if self.registry is not None:
                    self.registry.counter("obs.detect.regressions").inc()
        ab.add(dur)
        for name, d in totals.items():
            self.baseline(name).add(d)
        return reg

    def _attribute(self, chunk, dur, ab, z, factor, totals) -> StageRegression:
        """Pick the contained stage with the largest robust z that itself
        breaches; ties in blame go to the stronger signal."""
        best = None                  # (z, factor, name, d, median)
        for name, d in totals.items():
            sb = self.baselines.get(name)
            if sb is None or not sb.ready:
                continue
            sz, sf = sb.score(d)
            if sz > self.z_threshold and sf > self.min_factor:
                if best is None or sz > best[0]:
                    best = (sz, sf, name, d, sb.median())
        if best is None:
            return StageRegression(
                chunk=chunk, stage=None, anchor_duration=dur,
                anchor_baseline=ab.median(), anchor_z=z, anchor_factor=factor,
                stage_duration=0.0, stage_baseline=0.0,
                stage_z=0.0, stage_factor=0.0)
        sz, sf, name, d, med = best
        return StageRegression(
            chunk=chunk, stage=name, anchor_duration=dur,
            anchor_baseline=ab.median(), anchor_z=z, anchor_factor=factor,
            stage_duration=d, stage_baseline=med, stage_z=sz, stage_factor=sf)
