"""Jamba-1.5-Large 398B [arXiv:2403.19887] -- hybrid Mamba+attention 1:7
interleave with MoE 16e top-2 every other layer.

72L = 9 blocks x [8 layers]; attention at block position 3 (1 attn : 7
mamba); MoE at odd positions.  d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536.
"""
from repro_torch.models.config import (
    DENSE, FULL, MAMBA, MOE, LayerSpec, ModelConfig, MoEConfig, SSMConfig,
)

_UNIT = tuple(
    LayerSpec(
        FULL if i == 3 else MAMBA,
        MOE if i % 2 == 1 else DENSE,
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    unit=_UNIT,
    moe=MoEConfig(
        num_experts=16, top_k=2, num_shared=0, d_ff_expert=24576,
        capacity_factor=1.25,
    ),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256),
    tie_embeddings=False,
    mlp_activation="silu",
)
