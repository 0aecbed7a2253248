"""ServingRuntime — the serving engine as an elastic runtime application.

The request stream is the farm's input stream (paper §2); the engine's decode
slots are the S2 state partitions.  This module wires the pieces of
:mod:`repro_torch.runtime` around :class:`~repro_torch.serving.engine.ServingEngine`:

* an arrival model + request source feed a :class:`BackpressureQueue`
  (admission buffer — requests the engine hasn't accepted yet);
* each tick admits what fits, decodes every active slot (one SPMD step), and
  feeds the telemetry bus;
* the :class:`~repro_torch.runtime.autoscaler.Autoscaler` watches queue depth /
  utilization and changes the slot count through the engine's ONLINE
  ``resize`` — the §4.2 session-store handoff, not a re-creation.

Tokens/s is the throughput the bus tracks; "degree" is the slot count (the
number of sessions decoded per SPMD step — the serving notion of parallelism
degree).

Port of ``repro/serving/app.py`` over the port's engine, which runs on the
device it was built for.  A tick's wall, the chunk record the policies
read, covers the tick's device work: the engine's decode step ends in the
copy of the sampled tokens to the host, and each prefill in reading its
first token, both of which wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.runtime.autoscaler import (
    Autoscaler,
    Policy,
    QueueDepthPolicy,
    SLOLatencyPolicy,
)
from repro_torch.runtime.metrics import ChunkRecord, MetricsBus, ResizeRecord
from repro_torch.runtime.stream import ArrivalModel, BackpressureQueue, pump
from repro_torch.serving.engine import Request, ServingEngine


def request_source(
    *,
    vocab: int,
    prompt_lens: Sequence[int] = (5, 9, 13, 7),
    max_new_tokens: int = 8,
    total: Optional[int] = None,
    seed: int = 0,
):
    """Deterministic request factory: request ``i`` is a pure function of
    ``(seed, i)`` — the serving analogue of the regenerable token stream."""
    from repro_torch.runtime.stream import SyntheticSource

    def make(i: int) -> Request:
        rng = np.random.default_rng(np.uint64(seed * 1_000_003 + i))
        n = int(prompt_lens[i % len(prompt_lens)])
        return Request(
            rid=i,
            prompt=rng.integers(0, vocab, size=n).astype(np.int32),
            max_new_tokens=max_new_tokens,
        )

    return SyntheticSource(make, total=total)


@dataclasses.dataclass
class TickReport:
    t: int
    queue_depth: int
    active: int
    num_slots: int
    tokens_out: int


class ServingRuntime:
    """Drive a ServingEngine from a request stream with online slot scaling."""

    def __init__(
        self,
        engine: ServingEngine,
        source,
        arrivals: ArrivalModel,
        *,
        slot_candidates: Sequence[int],
        queue_capacity: int = 64,
        policy: Optional[Policy] = None,
        cooldown_ticks: int = 2,
        metrics: Optional[MetricsBus] = None,
        tracer=None,
        registry=None,
    ):
        self.engine = engine
        # thread the observability hooks into the engine so its
        # prefill/decode spans + latency histograms land in one trace
        if tracer is not None:
            engine.tracer = tracer
        if registry is not None:
            engine.registry = registry
        self.tracer = engine.tracer
        self.source = source
        self.arrivals = arrivals
        self.queue = BackpressureQueue(
            queue_capacity,
            high_watermark=max(2, (3 * queue_capacity) // 4),
            low_watermark=0,
        )
        self.metrics = metrics if metrics is not None else MetricsBus()
        policy = policy if policy is not None else QueueDepthPolicy()
        if (isinstance(policy, SLOLatencyPolicy) and policy.histogram is None
                and policy.tracker is not None
                and self.engine.registry is not None):
            # SLO-driven serving: the engine's decode latency histogram IS
            # the policy's burn-rate sample source (obs -> control loop)
            policy.histogram = self.engine.registry.histogram(
                "serving.decode_step_s")
        self.autoscaler = Autoscaler(
            policy,
            slot_candidates,
            cooldown_chunks=cooldown_ticks,
        )
        self._pending = None
        self.t = 0
        self.reports: List[TickReport] = []
        self.requests: List[Request] = []  # every request handed to the engine

    @property
    def drained(self) -> bool:
        return (
            self.source.exhausted
            and self.queue.depth == 0
            and self._pending is None
            and not self.engine.active
            and not self.engine.waiting
        )

    def _autoscale(self) -> None:
        target = self.autoscaler.propose(
            self.metrics, self.engine.num_slots, queue=self.queue
        )
        self.autoscaler.tick()
        if target is None:
            return
        moved = self.engine.resize(target)
        self.autoscaler.notify_resized()
        ev = self.engine.resize_events[-1]
        signal = getattr(self.autoscaler.policy, "last_signal", "")
        self.metrics.record_resize(
            ResizeRecord(
                t=self.metrics.clock.now(),
                n_old=ev["old"],
                n_new=ev["new"],
                protocol="S2-session-handoff",
                handoff_items=moved + ev["requeued"],
                reason=signal or f"queue_depth={self.queue.depth}",
            )
        )
        self.tracer.instant(
            "autoscale.decision", tick=self.t, current=ev["old"],
            proposed=ev["new"], applied=True,
            policy=type(self.autoscaler.policy).__name__,
            signal=signal or f"queue_depth={self.queue.depth}",
        )

    def tick(self) -> TickReport:
        """One runtime tick: arrivals -> queue -> admission -> decode."""
        self._pending = pump(
            self.source, self.arrivals, self.queue, self.t, pending=self._pending
        )
        self.queue.observe()
        self.metrics.record_depth(self.queue.depth)
        self._autoscale()
        # admit from the runtime queue into the engine's waiting line, at
        # most one queue-drain per tick (the engine applies its own policy)
        free = self.engine.num_slots - len(self.engine.active)
        if free > 0 and self.queue.depth:
            for req in self.queue.take(free):
                self.requests.append(req)
                self.engine.submit(req)
        t0 = self.metrics.clock.now()
        toks_before = self.engine.tokens_out
        with self.tracer.span(
            "tick", t=self.t, active=len(self.engine.active),
            queue_depth=self.queue.depth,
        ):
            self.engine.step()
        t1 = self.metrics.clock.now()
        produced = self.engine.tokens_out - toks_before
        self.metrics.record_chunk(
            ChunkRecord(
                t_start=t0,
                t_end=t1,
                m=produced,
                n_workers=self.engine.num_slots,
                queue_depth=self.queue.depth,
            )
        )
        rep = TickReport(
            t=self.t,
            queue_depth=self.queue.depth,
            active=len(self.engine.active),
            num_slots=self.engine.num_slots,
            tokens_out=self.engine.tokens_out,
        )
        self.reports.append(rep)
        self.t += 1
        return rep

    def run(self, max_ticks: int = 10_000) -> List[TickReport]:
        for _ in range(max_ticks):
            if self.drained:
                return self.reports
            self.tick()
        raise RuntimeError("serving runtime did not drain")
