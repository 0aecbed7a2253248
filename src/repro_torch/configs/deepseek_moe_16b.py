"""DeepSeekMoE-16B [arXiv:2401.06066] -- fine-grained MoE.

28L d_model=2048 16H (kv=16 = MHA) per-expert d_ff=1408 vocab=102400,
64 routed top-6 + 2 shared experts; first layer dense (d_ff=10944).
"""
from repro_torch.models.config import DENSE, FULL, MOE, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                 # dense first layer
    vocab_size=102_400,
    prefix=(LayerSpec(FULL, DENSE),),
    unit=(LayerSpec(FULL, MOE),),
    moe=MoEConfig(
        num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408,
        capacity_factor=1.25,
    ),
    tie_embeddings=False,
    mlp_activation="silu",
)
