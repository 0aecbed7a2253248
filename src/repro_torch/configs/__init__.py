"""Architecture registry of the port: ``get(name)`` / ``names()``.

The names and aliases are the reference's (``repro/configs/__init__.py``),
and every architecture it registers has a module here: the dense models,
the MoE models, Mamba2-780M, the Jamba hybrid, the prefix-LM VLM
(PaliGemma-3B) and the encoder-decoder (SeamlessM4T-medium).  Each module
is a copy of the reference's, built on the port's own
:mod:`repro_torch.models.config`.
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
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
