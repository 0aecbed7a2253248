"""CUDA kernels of the keyed plane, their plain PyTorch versions and the
dispatch between them (:mod:`repro_torch.kernels.ops`).  Kernels are built
from ``csrc/`` at first use (:mod:`repro_torch.kernels._build`)."""
