"""Per-architecture training knobs.

Port of the part of ``repro/launch/cells.py`` that one card uses:
``microbatches``, the gradient-accumulation factor (the paper's S3 flush
period: gradients are summed locally over ``k`` microbatches before the
optimizer commits them), ``remat`` (activation checkpointing of every
layer) and ``grad_accum_dtype`` (the accumulator's dtype).  The
reference's sharding knobs (``fsdp``, ``shard_kv_heads``, ``pure_dp``,
``moe_a2a``, ``zero1``) and ``decode_unroll`` belong to its meshes and are
not ported (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["CellKnobs", "knobs_for"]


@dataclasses.dataclass(frozen=True)
class CellKnobs:
    microbatches: int = 1              # S3 flush period (train only)
    remat: bool = True                 # activation checkpointing per layer
    grad_accum_dtype: str = "float32"  # "bfloat16" = compressed S3


_TRAIN_MICROBATCHES = {
    "codeqwen1.5-7b": 4,
    "gemma2-27b": 4,
    "minicpm-2b": 4,
    "granite-8b": 4,
    "kimi-k2-1t-a32b": 8,
    "deepseek-moe-16b": 2,
    "paligemma-3b": 2,
    "seamless-m4t-medium": 1,
    "mamba2-780m": 2,
    "jamba-1.5-large-398b": 8,
    "paper-synthetic": 1,
}


def knobs_for(cfg: ModelConfig, kind: str = "train",
              **overrides) -> CellKnobs:
    """The reference's knobs for ``cfg`` in a cell of ``kind`` (its
    ``ShapeConfig.kind``: ``"train"``, or a serving kind): a training cell
    takes the model's microbatches and remat."""
    train = kind == "train"
    base = CellKnobs(
        microbatches=_TRAIN_MICROBATCHES.get(cfg.name, 1) if train else 1,
        remat=train,
    )
    return dataclasses.replace(base, **overrides) if overrides else base
