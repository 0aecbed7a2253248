"""repro_torch.runtime — the elastic streaming runtime.

An :mod:`~repro_torch.runtime.stream` source feeds a backpressure queue;
the :mod:`~repro_torch.runtime.executor` drives a pattern adapter (one of
the SPMD adapters of S2-S5 over a worker mesh, or a host adapter such as
the keyed window plane) over fixed-size chunks; the
:mod:`~repro_torch.runtime.autoscaler` changes the degree online through
the adapter's resize protocol; the :mod:`~repro_torch.runtime.metrics` bus
closes the loop; the :mod:`~repro_torch.runtime.supervisor` adds
checkpoint-mediated failure shrink and recovery grow.
"""

from repro_torch.runtime.autoscaler import (
    Autoscaler,
    Decision,
    Policy,
    QueueDepthPolicy,
    SLOLatencyPolicy,
    ThroughputTargetPolicy,
    UtilizationPolicy,
)

from repro_torch.runtime.executor import (
    AccumulatorAdapter,
    PartitionedAdapter,
    PatternAdapter,
    ResizeInfo,
    SeparateAdapter,
    StreamExecutor,
    SuccessiveAdapter,
    default_mesh_factory,
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
from repro_torch.runtime.supervisor import (
    FailurePlan,
    Supervisor,
    SupervisorEvent,
    WorkerFailure,
)

__all__ = [
    "Autoscaler",
    "Decision",
    "Policy",
    "QueueDepthPolicy",
    "SLOLatencyPolicy",
    "ThroughputTargetPolicy",
    "UtilizationPolicy",
    "AccumulatorAdapter",
    "PartitionedAdapter",
    "PatternAdapter",
    "ResizeInfo",
    "SeparateAdapter",
    "StreamExecutor",
    "SuccessiveAdapter",
    "default_mesh_factory",
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
    "FailurePlan",
    "Supervisor",
    "SupervisorEvent",
    "WorkerFailure",
]
