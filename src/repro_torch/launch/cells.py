"""Per-(arch x shape) runtime knobs.

Port of ``repro/launch/cells.py``.  ``microbatches`` is the gradient
accumulation factor of a training cell, the paper's S3 flush period:
gradients are summed locally over ``k`` microbatches before the optimizer
commits them.  ``remat`` checkpoints every layer, ``grad_accum_dtype`` is
the accumulator's dtype.  The sharding knobs (``fsdp``,
``shard_kv_heads``, ``pure_dp``, ``moe_a2a``, ``zero1``) choose the
sharding rules of :func:`repro_torch.launch.steps.make_rules`, which the
dry-run reads and the steps run under on a live mesh (``zero1`` changes
nothing there: the port always gathers ZeRO shards at use).
``decode_unroll`` unrolls the reference's scanned decode layers for XLA;
the port's layers are a Python loop already, so the knob is carried for
the rules and the dry-run's record and changes nothing.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, ShapeConfig

__all__ = ["CellKnobs", "knobs_for"]


@dataclasses.dataclass(frozen=True)
class CellKnobs:
    microbatches: int = 1              # S3 flush period (train only)
    remat: bool = True                 # activation checkpointing per layer
    grad_accum_dtype: str = "float32"  # "bfloat16" = compressed S3
    fsdp: bool = True                  # ZeRO sharding of params/opt over "data"
    shard_kv_heads: bool = True
    pure_dp: bool = False              # the model axis joins data parallelism
    moe_a2a: bool = False              # expert-parallel all_to_all MoE (S2)
    decode_unroll: bool = False        # recorded only (see the docstring)
    zero1: bool = False                # per-layer weight gather


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


def knobs_for(cfg: ModelConfig, shape: ShapeConfig,
              **overrides) -> CellKnobs:
    """The reference's knobs for ``cfg`` in the cell of ``shape``: a
    training cell takes the model's microbatches and remat."""
    train = shape.kind == "train"
    base = CellKnobs(
        microbatches=_TRAIN_MICROBATCHES.get(cfg.name, 1) if train else 1,
        remat=train,
    )
    return dataclasses.replace(base, **overrides) if overrides else base
