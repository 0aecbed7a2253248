"""repro_torch — the PyTorch/CUDA port of ``repro``.

The JAX package ``repro`` stays the reference; this package mirrors it path
for path (``repro_torch/keyed/table.py`` is the port of
``repro/keyed/table.py``) and never imports it, nor JAX.  The slice ported
so far is the keyed windowed-state plane: ``StreamExecutor`` driving
``KeyedWindowAdapter``'s fused all-shard pass over device-resident window
tables, with the four TPU kernels on that path written in CUDA for the H100
(:mod:`repro_torch.kernels`).

Device rule (:mod:`repro_torch.device`): every entry point takes
``device=None``, which means the CUDA card and raises when there is none;
the CPU runs only when named (``device="cpu"``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
