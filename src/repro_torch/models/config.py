"""Model configuration: the port's own copy of ``repro/models/config.py``.

``ModelConfig``, ``LayerSpec``, ``MoEConfig`` and ``SSMConfig`` carry the
reference's fields and defaults unchanged, so a configuration built in
either package describes the same model (the tests compare them field by
field).  The dtype names stay strings; :attr:`ModelConfig.pdtype` and
:attr:`ModelConfig.cdtype` map them to torch dtypes.  ``ShapeConfig``, the
four shapes and :func:`shape_applicable` are the reference's input cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# mixer kinds
FULL = "full"          # full causal attention
SLIDING = "sliding"    # sliding-window causal attention
MAMBA = "mamba"        # Mamba2 SSD mixer
# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name (``"bfloat16"`` -> ``torch.bfloat16``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # FULL | SLIDING | MAMBA
    mlp: str    # DENSE | MOE | NONE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_bias: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # layer layout: prefix (unrolled) + unit repeated to fill num_layers
    prefix: Tuple[LayerSpec, ...] = ()
    unit: Tuple[LayerSpec, ...] = (LayerSpec(FULL, DENSE),)

    # attention details
    rope_theta: float = 1e4
    sliding_window: int = 4096
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norms: bool = False
    mlp_activation: str = "silu"        # silu | gelu
    tie_embeddings: bool = True
    residual_scale: float = 1.0
    embed_scale: bool = False
    norm_eps: float = 1e-6

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    encoder_layers: int = 0
    num_prefix_embeds: int = 0
    frontend_dim: int = 0

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = False
    decode_unroll: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it."""
        return -(-self.vocab_size // 256) * 256

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def layout(self) -> Tuple[Tuple[LayerSpec, ...], Tuple[LayerSpec, ...], int]:
        """``(prefix, unit, num_units)`` with
        ``len(prefix) + num_units * len(unit) == num_layers``."""
        rem = self.num_layers - len(self.prefix)
        if rem % len(self.unit):
            raise ValueError(
                f"{self.name}: {rem} layers not divisible by unit {len(self.unit)}"
            )
        return self.prefix, self.unit, rem // len(self.unit)

    @property
    def is_subquadratic(self) -> bool:
        """``long_500k`` eligibility, the reference's rule: SSM and hybrid
        architectures carry a compressed recurrent state, while a pure
        full-attention one would need a 524k-row KV cache in every
        layer."""
        return self.family in ("ssm", "hybrid")

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Every layer's spec in order: the prefix, then the unit repeated."""
        prefix, unit, n_units = self.layout()
        return tuple(prefix) + tuple(unit) * n_units

    # -- smoke-scale reduction -------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        small_moe = (
            dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                num_shared=min(self.moe.num_shared, 1),
                d_ff_expert=64,
            )
            if self.moe
            else None
        )
        small_ssm = (
            dataclasses.replace(self.ssm, d_state=16, headdim=8, chunk=16)
            if self.ssm
            else None
        )
        n_layers = len(self.prefix) + 2 * len(self.unit)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=16,
            encoder_layers=2 if self.encoder_layers else 0,
            num_prefix_embeds=min(self.num_prefix_embeds, 8),
            frontend_dim=32 if self.frontend_dim else 0,
            moe=small_moe,
            ssm=small_ssm,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the reference's four, by name)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not), the reference's rule and words."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention layers are quadratic at 524k context"
    return True, ""
