"""Granite-8B-Code [arXiv:2405.04324] -- llama-arch dense, GQA kv=8.

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    unit=(LayerSpec(FULL, DENSE),),
    rope_theta=1e7,
    tie_embeddings=True,
    mlp_activation="silu",
)
