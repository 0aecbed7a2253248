"""repro_torch — the PyTorch/CUDA port of ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors it path
for path (``repro_torch/keyed/table.py`` is the port of
``repro/keyed/table.py``) and never imports it, nor JAX.  Ported so far:
the keyed windowed-state plane (``StreamExecutor`` driving
``KeyedWindowAdapter`` over device-resident window tables, in process or
across worker processes), the five state access patterns, serving every
architecture the reference registers, and training (``models.transformer.
train_forward``, ``optim``, ``data``, ``launch.steps``, ``ft``); every TPU
kernel on those paths is written in CUDA for the H100
(:mod:`repro_torch.kernels`), and the training path's attention gradient
is a hand-written backward kernel.

Device rule (:mod:`repro_torch.device`): every entry point takes
``device=None``, which means the CUDA card and raises when there is none;
the CPU runs only when named (``device="cpu"``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
