"""Online parallelism-degree controller.

Policies are pure functions from observed signals to a target degree drawn
from a fixed candidate ladder (degrees that divide the chunk size and the
state's slot count — validated by the executor).  The autoscaler adds the
operational guardrails: cooldown between transitions, hysteresis (a policy
must ask for the same change twice in a row before it is applied — arrival
noise shouldn't thrash the farm), and the §4.x protocol invocation via
``StreamExecutor.set_degree``.

Three built-in policies mirror the three signals the paper's runtime
discussion cares about:

* :class:`QueueDepthPolicy` — backlog-driven: grow above the high watermark,
  shrink below the low one.
* :class:`UtilizationPolicy` — offered-load-driven, using the bus's queueing
  estimate ``lambda * t_f_hat / n_w``.
* :class:`ThroughputTargetPolicy` — model-driven: pick the smallest degree
  whose analytic service time (paper §2, with measured ``t_f_hat``) meets a
  throughput target.

:class:`SLOLatencyPolicy` closes the observability loop (PR 7): it plans
against a **latency percentile objective** instead of a throughput target,
reading the bus's rolling chunk records (optionally cross-checked by an
:class:`~repro_torch.obs.slo.SLOTracker` burn rate fed from obs histograms) and
proposing the smallest degree whose modeled p-quantile latency meets the
objective.  Every applied :class:`Decision` is annotated on the executor's
tracer with the triggering signal.

Port of ``repro/runtime/autoscaler.py`` (host code; the same decisions on
the same chunk records).  It reads the adapter's ``capacity_limit`` and the
executor's ``feasible_degrees`` as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core import analytics
from repro_torch.runtime.metrics import MetricsBus


class Policy:
    def target(
        self, bus: MetricsBus, current: int, candidates: Sequence[int], queue=None
    ) -> int:
        raise NotImplementedError


def _step_up(candidates: Sequence[int], current: int) -> int:
    ups = [c for c in candidates if c > current]
    return min(ups) if ups else current


def _step_down(candidates: Sequence[int], current: int) -> int:
    downs = [c for c in candidates if c < current]
    return max(downs) if downs else current


@dataclasses.dataclass
class QueueDepthPolicy(Policy):
    """Grow one rung when the queue is above its high watermark, shrink one
    rung when at/below the low watermark.  One rung at a time: the §4.x
    handoff cost is paid per transition, so the controller moves gradually."""

    def target(self, bus, current, candidates, queue=None) -> int:
        if queue is None:
            return current
        depth = queue.depth
        if depth >= queue.high_watermark:
            return _step_up(candidates, current)
        if depth <= queue.low_watermark:
            return _step_down(candidates, current)
        return current


@dataclasses.dataclass
class UtilizationPolicy(Policy):
    """Keep offered-load/capacity inside [low, high]."""

    low: float = 0.4
    high: float = 0.9

    def target(self, bus, current, candidates, queue=None) -> int:
        util = bus.utilization()
        if util is None:
            return current
        if util > self.high:
            return _step_up(candidates, current)
        if util < self.low:
            return _step_down(candidates, current)
        return current


@dataclasses.dataclass
class ThroughputTargetPolicy(Policy):
    """Smallest candidate degree whose modeled throughput meets the target.

    Modeled throughput at degree ``n`` is ``1 / T_s(n)`` items per unit time
    with the paper's ``T_s(n) = max(t_a, t_f_hat / n)`` — measured work
    plugged into the analytic model, so the controller and the benchmark's
    cross-check share one source of truth."""

    target_throughput: float
    t_a: float = 0.0

    def target(self, bus, current, candidates, queue=None) -> int:
        t_f = bus.t_f_hat
        if t_f is None:
            return current
        for n in sorted(candidates):
            ts = analytics.service_time(self.t_a, t_f, n)
            if ts > 0 and 1.0 / ts >= self.target_throughput:
                return n
        return max(candidates)


def _pquant(xs: List[float], q: float) -> Optional[float]:
    """Exact interpolated quantile (xs need not be sorted)."""
    if not xs:
        return None
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    i = int(math.floor(pos))
    if i + 1 >= len(xs):
        return xs[-1]
    frac = pos - i
    return xs[i] * (1 - frac) + xs[i + 1] * frac


@dataclasses.dataclass
class SLOLatencyPolicy(Policy):
    """Smallest degree whose modeled p-quantile latency meets the objective.

    **Partitioned mode** (the default, for chunked farms): each rolling
    chunk record is degree-normalized into *work* ``service_time *
    n_workers`` — valid under the paper's §2 model ``T(n) = max(t_a,
    work/n)`` and robust across resizes inside the window.  The policy takes
    the q-quantile of the work distribution and picks the smallest candidate
    ``n`` with ``max(t_a, work_q / n) <= objective * headroom`` — shrinking
    all the way down when over-provisioned, growing when breaching.  When an
    attached :class:`~repro_torch.obs.slo.SLOTracker` reports a burn-rate breach
    that the model disagrees with (its samples may come from elsewhere, e.g.
    registry histograms), the policy still steps up one rung: the budget is
    the promise, the model only a predictor.

    **Serving mode** (``mode="serving"``): tick latency does not scale like
    ``1/slots`` (decode cost *grows* with batch), so the policy is
    directional: breach or burn -> step the slot count down (smaller
    batches, faster ticks), healthy + queue pressure -> step up, else hold.

    If ``histogram`` is set (e.g. the serving ``decode_step_s`` registry
    histogram), each ``target()`` call first folds its new samples into the
    tracker — obs telemetry feeding the control loop directly.  The last
    decision rationale is published as ``last_signal``; the autoscaler
    stamps it onto every :class:`Decision` and the trace.
    """

    objective: float
    q: float = 0.99
    window: int = 16                 # rolling chunk records consulted
    headroom: float = 1.0            # plan against objective * headroom
    t_a: float = 0.0
    mode: str = "partitioned"        # "partitioned" | "serving"
    tracker: Optional[object] = None     # repro_torch.obs.slo.SLOTracker
    histogram: Optional[object] = None   # repro_torch.obs.metrics.Histogram
    last_signal: str = ""

    def _slo_verdict(self) -> str:
        if self.tracker is None:
            return "none"
        if self.histogram is not None:
            self.tracker.ingest_histogram(self.histogram)
        return self.tracker.evaluate().verdict

    def target(self, bus, current, candidates, queue=None) -> int:
        verdict = self._slo_verdict()
        recs = [r for r in bus.recent_chunks(self.window)
                if r.service_time > 0 and r.m > 0]
        if not recs:
            self.last_signal = f"hold: no chunk records (slo={verdict})"
            return current
        if self.mode == "serving":
            return self._serving_target(recs, verdict, current, candidates,
                                        queue)
        work_q = _pquant([r.service_time * r.n_workers for r in recs], self.q)
        budget = self.objective * self.headroom
        fits = [n for n in candidates
                if max(self.t_a, work_q / n) <= budget]
        predicted = max(self.t_a, work_q / current)
        if verdict == "breach" and (not fits or min(fits) <= current):
            # budget burning faster than the model explains: grow one rung
            n = _step_up(candidates, current)
            why = "burn-rate breach overrides model"
        elif fits:
            n = min(fits)
            why = "smallest modeled fit"
        else:
            n = max(candidates)
            why = "no candidate fits; max degree"
        self.last_signal = (
            f"p{self.q * 100:g}(work)={work_q:.4g} predicted(T@{current})="
            f"{predicted:.4g} objective={self.objective:.4g} "
            f"slo={verdict} -> {why}: {current}->{n}")
        return n

    def _serving_target(self, recs, verdict, current, candidates, queue) -> int:
        p = _pquant([r.service_time for r in recs], self.q)
        if p > self.objective * self.headroom or verdict == "breach":
            n = _step_down(candidates, current)
            why = "tick latency over objective; shrink batch"
        elif (queue is not None and queue.depth >= queue.high_watermark
              and verdict == "ok"):
            n = _step_up(candidates, current)
            why = "healthy + queue pressure; grow"
        else:
            n = current
            why = "hold"
        self.last_signal = (
            f"p{self.q * 100:g}(tick)={p:.4g} objective={self.objective:.4g} "
            f"slo={verdict} -> {why}: {current}->{n}")
        return n


@dataclasses.dataclass
class Decision:
    chunk_index: int
    current: int
    proposed: int
    applied: bool
    reason: str
    # migration volume of the applied transition (0 when nothing shipped):
    # scaling decisions are judged against the §4.2 handoff they cost
    handoff_slots: int = 0
    handoff_rows: int = 0
    handoff_bytes: int = 0
    # the telemetry that triggered the decision (policy's last_signal) —
    # every Decision is traceable back to the numbers that caused it
    signal: str = ""


class Autoscaler:
    """Wraps a policy with candidates, cooldown, and hysteresis, and applies
    accepted transitions through the executor's §4.x resize path."""

    def __init__(
        self,
        policy: Policy,
        candidates: Sequence[int],
        *,
        cooldown_chunks: int = 2,
        confirm: int = 1,
    ):
        if not candidates:
            raise ValueError("need at least one candidate degree")
        self.policy = policy
        self.candidates = sorted(set(candidates))
        self.cooldown_chunks = cooldown_chunks
        self.confirm = confirm  # consecutive identical proposals required
        self.decisions: List[Decision] = []
        self._since_resize = cooldown_chunks  # allow an immediate first move
        self._pending: Optional[int] = None
        self._pending_count = 0

    def propose(
        self, bus: MetricsBus, current: int, queue=None, feasible=None
    ) -> Optional[int]:
        """Pure decision (also used by ft/driver's elastic path): returns a
        target degree != current once cooldown+hysteresis are satisfied.

        ``feasible`` (optional) clamps the candidate ladder to degrees the
        pattern can actually run at — the fix for policies proposing
        degrees the state's ownership mode rejects (e.g. a non-divisor of
        ``num_slots`` under S2 block ownership).  ``maybe_scale`` supplies
        it from the executor's ``feasible_degrees``; slot-map stores report
        every degree feasible, so the clamp is a no-op there.
        """
        candidates = self.candidates
        if feasible is not None:
            feasible_set = set(feasible)
            candidates = [c for c in candidates if c in feasible_set]
            if not candidates:
                return None
        target = self.policy.target(bus, current, candidates, queue=queue)
        if target == current:
            # no-op is always legal — policies signal "hold" by returning
            # `current` even when the farm started off the candidate ladder
            self._pending, self._pending_count = None, 0
            return None
        if target not in candidates:
            raise ValueError(
                f"policy proposed degree {target} outside candidates "
                f"{candidates}"
            )
        if self._since_resize < self.cooldown_chunks:
            return None
        if target == self._pending:
            self._pending_count += 1
        else:
            self._pending, self._pending_count = target, 1
        if self._pending_count < self.confirm:
            return None
        return target

    def tick(self) -> None:
        """Advance the cooldown clock by one chunk (standalone `propose`
        users — e.g. the ft driver — call this once per decision period)."""
        self._since_resize += 1

    def notify_resized(self) -> None:
        """Reset cooldown/hysteresis after the caller applied a transition."""
        self._since_resize = 0
        self._pending, self._pending_count = None, 0

    def maybe_scale(self, executor, queue=None) -> Optional[Decision]:
        """Consult the policy and apply the transition if accepted.

        Before consulting the policy at all: if the adapter reports a
        ``capacity_limit`` below the current degree (a degraded distributed
        plane whose respawn capability failed), the degree is **forced**
        down onto the surviving capacity — capacity loss is a hard
        constraint, not a load signal, so it bypasses cooldown and
        hysteresis entirely."""
        bus = executor.metrics
        current = executor.degree
        cap = getattr(executor.adapter, "capacity_limit", None)
        if cap is not None and current > cap:
            feas = executor.feasible_degrees(self.candidates)
            target = max([c for c in feas if c <= cap], default=None)
            if target is not None and target < current:
                rec = executor.set_degree(
                    target,
                    reason=f"forced degrade: capacity limit {cap} "
                           f"< degree {current}",
                )
                self.notify_resized()
                d = Decision(
                    chunk_index=executor.chunks_done,
                    current=current,
                    proposed=target,
                    applied=rec is not None,
                    reason=rec.reason if rec else "noop",
                    handoff_slots=rec.handoff_items if rec else 0,
                    handoff_rows=rec.handoff_rows if rec else 0,
                    handoff_bytes=rec.handoff_bytes if rec else 0,
                    signal="capacity",
                )
                tracer = getattr(executor, "tracer", None)
                if tracer is not None:
                    tracer.instant(
                        "autoscale.decision", chunk=d.chunk_index,
                        current=current, proposed=target, applied=d.applied,
                        policy="capacity-guard", signal="forced degrade",
                    )
                self.decisions.append(d)
                return d
        target = self.propose(
            bus,
            current,
            queue=queue,
            feasible=executor.feasible_degrees(self.candidates),
        )
        self.tick()
        if target is None:
            return None
        rec = executor.set_degree(
            target,
            reason=f"{type(self.policy).__name__}: {current}->{target}",
        )
        self.notify_resized()
        signal = getattr(self.policy, "last_signal", "")
        d = Decision(
            chunk_index=executor.chunks_done,
            current=current,
            proposed=target,
            applied=rec is not None,
            reason=rec.reason if rec else "noop",
            handoff_slots=rec.handoff_items if rec else 0,
            handoff_rows=rec.handoff_rows if rec else 0,
            handoff_bytes=rec.handoff_bytes if rec else 0,
            signal=signal,
        )
        tracer = getattr(executor, "tracer", None)
        if tracer is not None:
            tracer.instant(
                "autoscale.decision", chunk=d.chunk_index, current=current,
                proposed=target, applied=d.applied,
                policy=type(self.policy).__name__, signal=signal or d.reason,
            )
        self.decisions.append(d)
        return d
