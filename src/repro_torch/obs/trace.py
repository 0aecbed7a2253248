"""Structured span tracing for the runtime's hot paths.

A :class:`Tracer` records **nested spans** — ``span("chunk") >
span("route") > ...`` — plus instant events (resizes, failures) and counter
samples (queue depth, occupancy), all stamped by a pluggable clock
(:class:`~repro_torch.obs.clock.WallClock` for real runs,
:class:`~repro_torch.obs.clock.LogicalClock` for bit-deterministic simulated
traces).  Finished spans are flat records ``(name, t0, t1, tid, depth,
args)``; nesting is carried by the per-thread depth counter and by
timestamp containment on the same track.

Overhead contract
    The **disabled** path is :data:`NULL_TRACER`: ``span()`` returns one
    shared no-op context manager, so an instrumented hot path pays a single
    attribute load + call per stage and allocates nothing.  The **enabled**
    path allocates one small object per span and reads the clock twice.
    Spans are host-clock spans: a stage that launches device work must
    synchronise before its span closes or the span measures the launch
    (the keyed adapter does so whenever its tracer is enabled).

Event buffers are bounded (``max_events``): a long-running serving process
keeps the newest events and counts the drop, it never grows without limit.
Drops are counted **per kind** (``dropped_spans`` / ``dropped_instants`` /
``dropped_counters``) and :meth:`Tracer.export_drops` publishes them as
registry counters so buffer saturation is visible in the metrics snapshot
instead of silent.

A :class:`FlightRecorder` is the complementary bound: a ring that keeps the
**newest** events (the main buffers keep the oldest), so the moments just
before a failure survive even on a saturated tracer.  The supervisor dumps
it as a Chrome-trace "black box" artifact on worker failure and
checkpoint-restore.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.clock import WallClock

# The record types are plain __slots__ classes, not dataclasses: a frozen
# dataclass pays ~1.5us of object.__setattr__ per construction, which lands
# INSIDE the parent span (the record is built after t1 is read) and was the
# dominant part of both the enabled-tracer overhead and the stage-coverage
# gap in the fused-plane benchmark.


class SpanRecord:
    """One finished span (``ph:"X"`` complete event in the export)."""

    __slots__ = ("name", "t0", "t1", "tid", "depth", "args")

    def __init__(self, name, t0, t1, tid, depth, args=None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid    # dense per-tracer thread id (0 = first thread seen)
        self.depth = depth  # nesting depth within its thread at entry
        self.args = args

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return (f"SpanRecord(name={self.name!r}, t0={self.t0}, t1={self.t1},"
                f" tid={self.tid}, depth={self.depth}, args={self.args})")


class InstantRecord:
    """A point event (``ph:"i"``): resize, failure, checkpoint, ..."""

    __slots__ = ("name", "t", "tid", "args")

    def __init__(self, name, t, tid, args=None):
        self.name = name
        self.t = t
        self.tid = tid
        self.args = args

    def __repr__(self) -> str:
        return (f"InstantRecord(name={self.name!r}, t={self.t},"
                f" tid={self.tid}, args={self.args})")


class CounterRecord:
    """A counter-track sample (``ph:"C"``) — Perfetto draws these as a
    stacked area series, e.g. queue depth or per-shard occupancy over
    time."""

    __slots__ = ("name", "t", "values")

    def __init__(self, name, t, values):
        self.name = name
        self.t = t
        self.values = values

    def __repr__(self) -> str:
        return (f"CounterRecord(name={self.name!r}, t={self.t},"
                f" values={self.values})")


class _ActiveSpan:
    """Context manager for one live span (enabled tracer only)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth", "_state")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_ActiveSpan":
        tr = self._tracer
        state = tr._thread_state()
        self._state = state
        self._depth = state[1]
        state[1] += 1
        self._t0 = tr.clock.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        t1 = tr.clock.now()
        state = self._state
        state[1] -= 1
        tr._append(
            tr.spans,
            SpanRecord(self._name, self._t0, t1, state[0], self._depth,
                       self._args),
        )


class Tracer:
    """Collect spans / instants / counter samples against one clock.

    Thread-safe by construction: each thread gets its own dense ``tid`` and
    depth counter (the executor's pipeline prepare worker shows up as its
    own Perfetto track), and buffer appends hold a lock only long enough to
    append-or-drop.
    """

    enabled = True

    def __init__(self, *, clock=None, max_events: int = 1_000_000,
                 recorder: Optional["FlightRecorder"] = "default"):  # type: ignore[assignment]
        self.clock = clock if clock is not None else WallClock()
        self.max_events = max_events
        self.spans: List[SpanRecord] = []
        self.instants: List[InstantRecord] = []
        self.counters: List[CounterRecord] = []
        self.dropped_spans = 0
        self.dropped_instants = 0
        self.dropped_counters = 0
        # every enabled tracer feeds the process-wide black box by default
        # (pass recorder=None to opt out); the ring keeps NEWEST events, so
        # it still sees what a saturated main buffer drops
        self.recorder = FLIGHT_RECORDER if recorder == "default" else recorder
        #: explicit track labels (``tid -> name``) for tracks reserved via
        #: :meth:`alloc_track`; the Chrome-trace export names them verbatim
        self.track_names: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_tid = 0
        self._n_events = 0

    @property
    def dropped(self) -> int:
        """Total events dropped by the bounded buffers (all kinds)."""
        return self.dropped_spans + self.dropped_instants + self.dropped_counters

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args) -> _ActiveSpan:
        """``with tracer.span("route", cells=n): ...`` — one nested span."""
        return _ActiveSpan(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        self._append(
            self.instants,
            InstantRecord(name, self.clock.now(), self._thread_state()[0],
                          args or None),
        )

    def counter(self, name: str, **values) -> None:
        """Sample one counter track: ``tracer.counter("queue", depth=7)``."""
        self._append(
            self.counters,
            CounterRecord(name, self.clock.now(), values),
        )

    # -- external event sources (cross-process timelines) --------------------
    def alloc_track(self, name: str) -> int:
        """Reserve a dense ``tid`` for an **external** event source — e.g.
        one shard-host process of the distributed keyed plane — so its spans
        render as their own named Perfetto track.  The reserved tid is never
        handed to a local thread (it comes from the same counter
        :meth:`_thread_state` draws from)."""
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            self.track_names[tid] = name
        return tid

    def record_span(
        self, name: str, t0: float, t1: float, *, tid: int, depth: int = 0,
        **args,
    ) -> None:
        """Append a span timed by someone else (a worker process stamping
        ``time.perf_counter`` — ``CLOCK_MONOTONIC``, shared across processes
        on the same Linux host, so cross-process spans land on one coherent
        timeline).  Feeds the flight recorder exactly like locally-timed
        spans."""
        self._append(
            self.spans, SpanRecord(name, t0, t1, tid, depth, args or None)
        )

    # -- internals -----------------------------------------------------------
    def _thread_state(self) -> List[int]:
        """``[tid, depth]`` for the calling thread (created on first use)."""
        state = getattr(self._local, "state", None)
        if state is None:
            with self._lock:
                state = [self._next_tid, 0]
                self._next_tid += 1
            self._local.state = state
        return state

    def _append(self, buf: List, rec) -> None:
        recorder = self.recorder
        if recorder is not None:
            # before the drop check: the black box keeps newest events even
            # when the main buffer is saturated
            recorder.push(rec)
        with self._lock:
            if self._n_events >= self.max_events:
                if type(rec) is SpanRecord:
                    self.dropped_spans += 1
                elif type(rec) is InstantRecord:
                    self.dropped_instants += 1
                else:
                    self.dropped_counters += 1
                return
            self._n_events += 1
            buf.append(rec)

    # -- inspection ----------------------------------------------------------
    def reset(self) -> None:
        """Drop buffered events (benchmarks reset after warmup)."""
        with self._lock:
            self.spans.clear()
            self.instants.clear()
            self.counters.clear()
            self.dropped_spans = 0
            self.dropped_instants = 0
            self.dropped_counters = 0
            self._n_events = 0

    def export_drops(self, registry) -> None:
        """Publish per-kind drop counts as registry counters
        (``obs.tracer.dropped_spans`` / ``..._instants`` / ``..._counters``),
        so buffer saturation shows up in the metrics snapshot."""
        registry.counter("obs.tracer.dropped_spans").value = self.dropped_spans
        registry.counter("obs.tracer.dropped_instants").value = self.dropped_instants
        registry.counter("obs.tracer.dropped_counters").value = self.dropped_counters

    def total_by_name(self) -> Dict[str, Tuple[int, float]]:
        """``name -> (count, total duration)`` over the buffered spans."""
        out: Dict[str, Tuple[int, float]] = {}
        for s in self.spans:
            n, tot = out.get(s.name, (0, 0.0))
            out[s.name] = (n + 1, tot + s.duration)
        return out


class _NullSpan:
    """Shared no-op context manager: the disabled hot path's whole cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op returning shared
    singletons, so instrumented code pays only a branchless call.  Carries a
    real :class:`~repro_torch.obs.clock.WallClock` so code that reads
    ``tracer.clock`` for its own timing keeps working when tracing is off."""

    enabled = False

    def __init__(self):
        self.clock = WallClock()
        self.spans: List[SpanRecord] = []
        self.instants: List[InstantRecord] = []
        self.counters: List[CounterRecord] = []
        self.track_names: Dict[int, str] = {}
        self.dropped = 0

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        return None

    def alloc_track(self, name: str) -> int:
        return 0

    def record_span(
        self, name: str, t0: float, t1: float, *, tid: int = 0,
        depth: int = 0, **args,
    ) -> None:
        return None

    def counter(self, name: str, **values) -> None:
        return None

    def reset(self) -> None:
        return None

    def total_by_name(self) -> Dict[str, Tuple[int, float]]:
        return {}

    def export_drops(self, registry) -> None:
        return None


#: the process-wide disabled tracer — instrumented modules default to this
NULL_TRACER = NullTracer()


class FlightRecorder:
    """Bounded ring of the **newest** spans / instants / counter samples,
    plus a short ring of metrics snapshots — the runtime's black box.

    The main tracer buffers keep the *oldest* ``max_events`` events and count
    drops; the recorder inverts that, so the timeline leading *into* a
    failure is always available.  :meth:`dump` writes a Chrome-trace artifact
    (the recorder duck-types the `Tracer` surface `chrome_trace` reads), and
    the supervisor calls it on worker failure and checkpoint-restore.
    """

    def __init__(self, capacity: int = 4096, metrics_capacity: int = 16):
        self.capacity = capacity
        self.spans = deque(maxlen=capacity)
        self.instants = deque(maxlen=capacity)
        self.counters = deque(maxlen=capacity)
        self.metrics_ring = deque(maxlen=metrics_capacity)
        self.dropped = 0   # rings overwrite, they never silently drop

    def push(self, rec) -> None:
        """Called by `Tracer._append` for every event (even dropped ones)."""
        if type(rec) is SpanRecord:
            self.spans.append(rec)
        elif type(rec) is InstantRecord:
            self.instants.append(rec)
        else:
            self.counters.append(rec)

    def sample_metrics(self, registry, t: Optional[float] = None) -> None:
        """Append one registry snapshot to the (short) metrics ring."""
        self.metrics_ring.append({"t": t, "snapshot": registry.snapshot()})

    def reset(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self.counters.clear()
        self.metrics_ring.clear()

    def __len__(self) -> int:
        return len(self.spans) + len(self.instants) + len(self.counters)

    def dump(self, path: str, *, registry=None,
             process_name: str = "blackbox") -> dict:
        """Write the ring as a Chrome-trace JSON "black box" and return the
        document.  ``registry`` adds a final metrics snapshot; the rolling
        :attr:`metrics_ring` rides along under ``otherData``."""
        from repro_torch.obs.export import write_trace

        return write_trace(path, self, registry=registry,
                           process_name=process_name,
                           extra={"metrics_ring": list(self.metrics_ring)})


#: the process-wide black box every enabled `Tracer` feeds by default
FLIGHT_RECORDER = FlightRecorder()
