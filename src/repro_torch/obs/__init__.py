"""`repro_torch.obs` — span tracing and the metrics registry the executor
and the keyed plane's ``export_health`` need.  SLOs, regression detection
and the Chrome-trace export are a later slice.

Disabled by default everywhere: instrumented hot paths hold
:data:`~repro_torch.obs.trace.NULL_TRACER` and pay one attribute load +
no-op call per stage.
"""

from repro_torch.obs.clock import LogicalClock, WallClock
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    FLIGHT_RECORDER,
    NULL_TRACER,
    CounterRecord,
    FlightRecorder,
    InstantRecord,
    NullTracer,
    SpanRecord,
    Tracer,
)

__all__ = [
    "FLIGHT_RECORDER",
    "NULL_TRACER",
    "Counter",
    "CounterRecord",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InstantRecord",
    "LogicalClock",
    "MetricsRegistry",
    "NullTracer",
    "SpanRecord",
    "Tracer",
    "WallClock",
]
