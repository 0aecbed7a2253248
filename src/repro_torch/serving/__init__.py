"""repro_torch.serving -- the continuous-batching session store
(:class:`~repro_torch.serving.engine.ServingEngine`) and the elastic runtime
that drives it from a request stream
(:class:`~repro_torch.serving.app.ServingRuntime`)."""

from repro_torch.serving.app import ServingRuntime, TickReport, request_source
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine", "ServingRuntime", "TickReport",
           "request_source"]
