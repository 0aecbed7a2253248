"""The port's device rule.

Every entry point takes ``device=None``.  ``None`` means the CUDA card; when
no card is present that raises instead of quietly running on the CPU.  The
CPU is used only when a caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); anything
    else is taken as given, and a named CUDA device also needs a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               f"unavailable")
        if dev.index is None:  # "cuda" names the current card, as tensors do
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
