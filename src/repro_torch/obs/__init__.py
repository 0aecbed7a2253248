"""`repro_torch.obs` — structured observability for the elastic runtime.

Nested span tracing over the keyed plane, the executor and the serving
engine (:mod:`~repro_torch.obs.trace`), a counters/gauges/log-bucket
histogram registry (:mod:`~repro_torch.obs.metrics`), Chrome/Perfetto
trace export (:mod:`~repro_torch.obs.export`), a markdown report renderer
(``python -m repro_torch.obs.report``), declarative SLOs with error-budget
burn rates (:mod:`~repro_torch.obs.slo`), an online per-stage regression
detector (:mod:`~repro_torch.obs.detect`), and the
:class:`~repro_torch.obs.trace.FlightRecorder` black box the supervisor
dumps on failure.

Disabled by default everywhere: instrumented hot paths hold
:data:`~repro_torch.obs.trace.NULL_TRACER` and pay one attribute load +
no-op call per stage.
"""

from repro_torch.obs.clock import LogicalClock, WallClock
from repro_torch.obs.detect import (
    RegressionDetector,
    StageBaseline,
    StageRegression,
)
from repro_torch.obs.export import chrome_trace, write_metrics, write_trace
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.slo import SLOEngine, SLOSpec, SLOStatus, SLOTracker
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
    "RegressionDetector",
    "SLOEngine",
    "SLOSpec",
    "SLOStatus",
    "SLOTracker",
    "SpanRecord",
    "StageBaseline",
    "StageRegression",
    "Tracer",
    "WallClock",
    "chrome_trace",
    "write_metrics",
    "write_trace",
]
