"""Architecture registry of the port: ``get(name)`` / ``names()``.

The names and aliases are the reference's (``repro/configs/__init__.py``).
The port serves the dense attention models, Mamba2-780M and
DeepSeekMoE-16B so far; the other architectures raise
``NotImplementedError`` until their slice lands (ROADMAP Queue 1 item 12:
the other dense and MoE models, the hybrid, the encoder-decoder and the
prefix-embedding frontends).
"""

from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.models.config import ModelConfig

#: every architecture the reference registers, in its order
_ARCHS = (
    "codeqwen1_5_7b",
    "gemma2_27b",
    "minicpm_2b",
    "granite_8b",
    "kimi_k2_1t_a32b",
    "deepseek_moe_16b",
    "paligemma_3b",
    "seamless_m4t_medium",
    "mamba2_780m",
    "jamba_1_5_large_398b",
    "paper_synthetic",
)
#: the architectures the port has a configuration module for
PORTED = ("gemma2_27b", "deepseek_moe_16b", "mamba2_780m",
          "paper_synthetic")

_ALIAS = {name.replace("_", "-"): name for name in _ARCHS}
_ALIAS.update(
    {
        "codeqwen1.5-7b": "codeqwen1_5_7b",
        "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
        "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    }
)


def names() -> Tuple[str, ...]:
    return tuple(n for n in _ARCHS if n != "paper_synthetic")


def get(name: str) -> ModelConfig:
    mod_name = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIAS)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP Queue 1 item 12); the port "
            f"has {sorted(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
