"""Declarative latency/throughput objectives with error-budget accounting.

Port of ``repro/obs/slo.py`` (pure Python, the same arithmetic).

An :class:`SLOSpec` states the promise — "p99 chunk latency <= 70ms with
99% compliance" — and an :class:`SLOTracker` evaluates it **streamingly**:
each sample (or histogram delta) becomes one good/bad tick, compliance is
tracked over two rolling windows, and the classic SRE multi-window
burn-rate rule decides the verdict:

* ``burn_rate(window) = bad_fraction / error_budget`` where the error
  budget is ``1 - compliance`` — burn 1.0 means the budget is being spent
  exactly as fast as the SLO allows, burn 10 means ten times faster;
* **breach** when the *short* window burns above ``fast_burn`` AND the
  *long* window above ``slow_burn`` (both windows must agree, so a single
  slow chunk cannot page), **warn** when only the long window burns,
  **ok** otherwise.

Verdict *transitions* emit ``slo.ok`` / ``slo.warn`` / ``slo.breach``
instants onto the tracer, so the trace timeline shows exactly when an
objective started and stopped failing — next to the spans that caused it.

Samples can arrive two ways, freely mixed per tracker:

* :meth:`SLOTracker.observe` — one latency sample (the tracker keeps a
  bounded window of raw samples for an exact windowed percentile);
* :meth:`SLOTracker.ingest_histogram` — diff a (cumulative, monotone)
  :class:`~repro_torch.obs.metrics.Histogram` against the last ingest, counting
  new samples above the objective's bucket as bad.  This is sample-free:
  the serving engine's ``prefill``/``decode`` registry histograms feed the
  autoscaler's SLO policy this way.

:class:`SLOEngine` is the board: named trackers, one ``evaluate_all()``
per control tick, and a gauge export (``slo.<name>.*``) for the metrics
snapshot.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs.trace import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective.

    ``objective`` is the latency ceiling (seconds, or logical units under a
    LogicalClock); a sample is *bad* when it exceeds it.  ``compliance`` is
    the promised fraction of good samples, so the error budget is
    ``1 - compliance``.  ``throughput_floor`` optionally also breaches when
    an externally supplied rate drops below it.
    """

    name: str
    objective: float
    q: float = 0.99                  # reported percentile
    compliance: float = 0.99         # promised good fraction
    short_window: int = 32           # ticks — the fast page signal
    long_window: int = 256           # ticks — the slow/ticket signal
    fast_burn: float = 8.0           # short-window burn threshold
    slow_burn: float = 2.0           # long-window burn threshold
    throughput_floor: Optional[float] = None

    def __post_init__(self):
        if self.objective <= 0:
            raise ValueError(f"objective must be > 0, got {self.objective}")
        if not 0 < self.compliance < 1:
            raise ValueError(f"compliance must be in (0, 1), got {self.compliance}")
        if not 0 < self.q <= 1:
            raise ValueError(f"q must be in (0, 1], got {self.q}")
        if not 0 < self.short_window <= self.long_window:
            raise ValueError("need 0 < short_window <= long_window, got "
                             f"{self.short_window} / {self.long_window}")
        if not self.fast_burn >= self.slow_burn > 0:
            # the short window is the *faster* page signal: its threshold
            # must be at least the slow one or warn/breach invert
            raise ValueError("need fast_burn >= slow_burn > 0, got "
                             f"{self.fast_burn} / {self.slow_burn}")

    @property
    def budget(self) -> float:
        """Error budget: the allowed bad fraction."""
        return 1.0 - self.compliance


@dataclasses.dataclass(frozen=True)
class SLOStatus:
    """One evaluation result (also the trace-instant payload)."""

    name: str
    verdict: str                     # "ok" | "warn" | "breach"
    p: Optional[float]               # observed latency at spec.q
    objective: float
    burn_short: Optional[float]
    burn_long: Optional[float]
    budget_remaining: float          # lifetime; < 0 means budget blown
    samples: int


def _quantile(sorted_xs: List[float], q: float) -> Optional[float]:
    """Exact interpolated quantile of an already-sorted list."""
    if not sorted_xs:
        return None
    if len(sorted_xs) == 1:
        return sorted_xs[0]
    pos = q * (len(sorted_xs) - 1)
    i = int(math.floor(pos))
    frac = pos - i
    if i + 1 >= len(sorted_xs):
        return sorted_xs[-1]
    return sorted_xs[i] * (1 - frac) + sorted_xs[i + 1] * frac


class SLOTracker:
    """Streaming evaluation of one :class:`SLOSpec`.

    State is bounded: a deque of ``(n, bad)`` ticks capped at the long
    window, a deque of raw samples (for the exact windowed percentile) of
    the same cap, and two lifetime integers for the error budget.
    """

    def __init__(self, spec: SLOSpec, *, tracer=NULL_TRACER):
        self.spec = spec
        self.tracer = tracer
        self.ticks: Deque[Tuple[int, int]] = deque(maxlen=spec.long_window)
        self.samples: Deque[float] = deque(maxlen=spec.long_window)
        self.total_n = 0
        self.total_bad = 0
        self.breaches = 0            # ok/warn -> breach transitions
        self.last_status: Optional[SLOStatus] = None
        self._verdict = "ok"
        self._hist = None            # last histogram fed to ingest_histogram
        self._hist_seen = (0, 0)     # (count, bad) cumulative at last ingest

    # -- sample intake -------------------------------------------------------
    def observe(self, v: float) -> None:
        """One latency sample; bad iff it exceeds the objective."""
        bad = 1 if v > self.spec.objective else 0
        self.ticks.append((1, bad))
        self.samples.append(v)
        self.total_n += 1
        self.total_bad += bad

    def ingest_histogram(self, hist) -> int:
        """Fold in everything ``hist`` recorded since the last ingest.

        The histogram is cumulative and monotone, so the delta of
        ``(count, samples-above-objective)`` since last time is exactly the
        new traffic; "above objective" is resolved at bucket resolution
        (buckets strictly above the one containing the objective).  Returns
        the number of new samples folded in.
        """
        bad_cum = self._bad_cumulative(hist)
        if hist is not self._hist:
            self._hist = hist
            self._hist_seen = (0, 0)
        n = hist.count - self._hist_seen[0]
        bad = bad_cum - self._hist_seen[1]
        self._hist_seen = (hist.count, bad_cum)
        if n <= 0:
            return 0
        self.ticks.append((n, bad))
        self.total_n += n
        self.total_bad += bad
        return n

    def _bad_cumulative(self, hist) -> int:
        """Samples recorded above the objective, at bucket resolution."""
        v = self.spec.objective
        if v < hist.lo:
            idx = 0
        else:
            idx = 1 + int(math.log(v / hist.lo) * hist._scale)
            idx = min(idx, len(hist.counts) - 1)
        return sum(hist.counts[idx + 1:])

    # -- derived signals -----------------------------------------------------
    def burn_rate(self, window: int) -> Optional[float]:
        """Bad fraction over the last ``window`` ticks, normalized by the
        error budget (1.0 = spending exactly at the allowed rate)."""
        ticks = list(self.ticks)[-window:]
        n = sum(t[0] for t in ticks)
        if n == 0:
            return None
        bad = sum(t[1] for t in ticks)
        return (bad / n) / self.spec.budget

    def budget_remaining(self) -> float:
        """Lifetime error budget left, as a fraction of the budget (1.0 =
        untouched, 0 = exactly spent, negative = blown)."""
        if self.total_n == 0:
            return 1.0
        spent = (self.total_bad / self.total_n) / self.spec.budget
        return 1.0 - spent

    def percentile(self) -> Optional[float]:
        """Observed latency at ``spec.q``: exact over the raw-sample window
        when samples were observed directly, else the histogram's value."""
        if self.samples:
            return _quantile(sorted(self.samples), self.spec.q)
        if self._hist is not None and self._hist.count:
            return self._hist.percentile(self.spec.q)
        return None

    # -- verdict -------------------------------------------------------------
    def evaluate(self, *, throughput: Optional[float] = None) -> SLOStatus:
        """Compute the current verdict; emit a trace instant on transitions."""
        spec = self.spec
        p = self.percentile()
        burn_s = self.burn_rate(spec.short_window)
        burn_l = self.burn_rate(spec.long_window)
        if (burn_s is not None and burn_s >= spec.fast_burn
                and burn_l is not None and burn_l >= spec.slow_burn):
            verdict = "breach"
        elif burn_l is not None and burn_l >= spec.slow_burn:
            verdict = "warn"
        else:
            verdict = "ok"
        if (spec.throughput_floor is not None and throughput is not None
                and throughput < spec.throughput_floor):
            verdict = "breach"
        status = SLOStatus(
            name=spec.name, verdict=verdict, p=p, objective=spec.objective,
            burn_short=burn_s, burn_long=burn_l,
            budget_remaining=self.budget_remaining(), samples=self.total_n,
        )
        if verdict != self._verdict:
            if verdict == "breach":
                self.breaches += 1
            self.tracer.instant(
                f"slo.{verdict}", slo=spec.name,
                p=-1.0 if p is None else p, objective=spec.objective,
                burn_short=-1.0 if burn_s is None else burn_s,
                burn_long=-1.0 if burn_l is None else burn_l,
                budget_remaining=status.budget_remaining,
            )
            self._verdict = verdict
        self.last_status = status
        return status


class SLOEngine:
    """A board of named trackers sharing one tracer."""

    def __init__(self, *, tracer=NULL_TRACER):
        self.tracer = tracer
        self.trackers: Dict[str, SLOTracker] = {}

    def add(self, spec: SLOSpec) -> SLOTracker:
        if spec.name in self.trackers:
            raise ValueError(f"duplicate SLO {spec.name!r}")
        tr = SLOTracker(spec, tracer=self.tracer)
        self.trackers[spec.name] = tr
        return tr

    def __getitem__(self, name: str) -> SLOTracker:
        return self.trackers[name]

    def evaluate_all(self) -> Dict[str, SLOStatus]:
        return {name: tr.evaluate() for name, tr in self.trackers.items()}

    def export(self, registry) -> None:
        """Publish per-objective gauges/counters into a metrics registry."""
        for name, tr in self.trackers.items():
            st = tr.last_status
            if st is None:
                continue
            registry.gauge(f"slo.{name}.p").set(-1.0 if st.p is None else st.p)
            registry.gauge(f"slo.{name}.objective").set(st.objective)
            registry.gauge(f"slo.{name}.burn_short").set(
                -1.0 if st.burn_short is None else st.burn_short)
            registry.gauge(f"slo.{name}.burn_long").set(
                -1.0 if st.burn_long is None else st.burn_long)
            registry.gauge(f"slo.{name}.budget_remaining").set(st.budget_remaining)
            registry.counter(f"slo.{name}.breaches").value = tr.breaches

    def snapshot(self) -> Dict[str, Dict]:
        return {
            name: dataclasses.asdict(tr.last_status)
            for name, tr in sorted(self.trackers.items())
            if tr.last_status is not None
        }
