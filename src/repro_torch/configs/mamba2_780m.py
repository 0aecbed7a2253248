"""Mamba2-780M [arXiv:2405.21060; unverified] -- SSD (state-space duality).

48L d_model=1536 attn-free, ssm_state=128, vocab=50280.
headdim=64, expand=2 => d_inner=3072, 48 heads.
"""
from repro_torch.models.config import MAMBA, NONE, LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    unit=(LayerSpec(MAMBA, NONE),),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=256),
    tie_embeddings=True,
)
