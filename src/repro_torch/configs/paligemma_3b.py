"""PaliGemma-3B [arXiv:2407.07726] -- VLM: SigLIP frontend (STUB) + gemma-2B
backbone with prefix-LM masking over 256 image-patch embeddings.

18L d_model=2048 8H (MQA kv=1, head_dim 256) d_ff=16384 vocab=257216.
The SigLIP tower is stubbed per spec: input_specs() supplies precomputed
patch embeddings [B, 256, 1152], projected into the backbone.
"""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    unit=(LayerSpec(FULL, DENSE),),
    num_prefix_embeds=256,
    frontend_dim=1152,          # SigLIP-So400m output width
    embed_scale=True,
    mlp_activation="gelu",
    tie_embeddings=True,
)
