"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; unverified] -- trillion-param MoE.

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 routed top-8 + 1 shared expert; first layer dense (DeepSeek-V3
family); aux-loss-free router bias.  head_dim=128 (explicit; 7168/64=112 is
not MXU-aligned).  Dense first-layer d_ff=18432 (DSv3 convention) -- recorded
assumption (the assigned table only pins the expert d_ff).
"""
from repro_torch.models.config import DENSE, FULL, MOE, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                 # dense first layer + not used by experts
    vocab_size=163_840,
    prefix=(LayerSpec(FULL, DENSE),),
    unit=(LayerSpec(FULL, MOE),),
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        num_shared=1,
        d_ff_expert=2048,
        capacity_factor=1.25,
        router_bias=True,       # aux-loss-free balancing
    ),
    rope_theta=5e6,
    tie_embeddings=False,
    mlp_activation="silu",
)
