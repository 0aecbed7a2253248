"""Gemma2-27B [arXiv:2408.00118] -- dense, local+global alternating attention,
attn/final logit softcaps, pre+post RMSNorm pairs.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim 128.
"""
from repro_torch.models.config import DENSE, FULL, SLIDING, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    unit=(LayerSpec(SLIDING, DENSE), LayerSpec(FULL, DENSE)),  # local, global
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    mlp_activation="gelu",
    tie_embeddings=True,
)
