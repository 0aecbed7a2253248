"""Core: the paper's state access patterns, semantics, analytics, simulator."""

from repro_torch.core.analytics import (
    Roofline,
    accumulator_completion,
    completion_time,
    ideal_completion,
    paper_flush_threshold,
    partitioned_completion,
    separate_speedup,
    separate_speedup_bound,
    service_time,
    stable_flush_period,
)
from repro_torch.core.farm import TaskFarm, pipeline_stages
from repro_torch.core.mesh import WorkerMesh
from repro_torch.core.patterns import (
    AccumulatorState,
    PartitionedState,
    SeparateTaskState,
    SerialState,
    SuccessiveApproximationState,
)

__all__ = [
    "AccumulatorState",
    "PartitionedState",
    "SeparateTaskState",
    "SerialState",
    "SuccessiveApproximationState",
    "TaskFarm",
    "WorkerMesh",
    "pipeline_stages",
    "Roofline",
    "accumulator_completion",
    "completion_time",
    "ideal_completion",
    "paper_flush_threshold",
    "partitioned_completion",
    "separate_speedup",
    "separate_speedup_bound",
    "service_time",
    "stable_flush_period",
]
