"""repro_torch.serving -- the continuous-batching session store
(:class:`~repro_torch.serving.engine.ServingEngine`)."""

from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
