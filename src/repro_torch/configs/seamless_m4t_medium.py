"""SeamlessM4T-medium [arXiv:2308.11596] -- enc-dec, multimodal (audio STUB).

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  Realized as a 12L
bidirectional encoder over stubbed speech-frame embeddings + 12L causal
decoder with per-layer cross-attention.  Frontend (w2v-BERT conformer) is a
stub per spec: input_specs() supplies precomputed frames [B, S/4, 1024].
"""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,              # decoder layers; +12 encoder below
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    unit=(LayerSpec(FULL, DENSE),),
    encoder_layers=12,
    frontend_dim=1024,
    tie_embeddings=True,
    mlp_activation="silu",
)
