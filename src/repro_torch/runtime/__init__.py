"""repro_torch.runtime — the elastic streaming runtime, host-adapter path.

An :mod:`~repro_torch.runtime.stream` source feeds a backpressure queue;
the :mod:`~repro_torch.runtime.executor` drives a host pattern adapter over
fixed-size chunks; the :mod:`~repro_torch.runtime.metrics` bus records
chunks and resizes.  The autoscaler, the supervisor and the SPMD adapters
are a later slice.
"""

from repro_torch.runtime.executor import (
    PatternAdapter,
    ResizeInfo,
    StreamExecutor,
    run_stream,
)
from repro_torch.runtime.metrics import (
    ChunkRecord,
    LogicalClock,
    MetricsBus,
    ResizeRecord,
    WallClock,
)
from repro_torch.runtime.stream import (
    ArrivalModel,
    BackpressureQueue,
    BoundedSource,
    BurstyRate,
    Chunker,
    ConstantRate,
    PoissonRate,
    SinusoidRate,
    Source,
    SyntheticSource,
    pump,
)

__all__ = [
    "PatternAdapter",
    "ResizeInfo",
    "StreamExecutor",
    "run_stream",
    "ChunkRecord",
    "LogicalClock",
    "MetricsBus",
    "ResizeRecord",
    "WallClock",
    "ArrivalModel",
    "BackpressureQueue",
    "BoundedSource",
    "BurstyRate",
    "Chunker",
    "ConstantRate",
    "PoissonRate",
    "SinusoidRate",
    "Source",
    "SyntheticSource",
    "pump",
]
