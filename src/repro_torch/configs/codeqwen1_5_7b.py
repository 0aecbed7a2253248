"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] -- dense, qwen1.5 arch.

32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416.
"""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    unit=(LayerSpec(FULL, DENSE),),
    rope_theta=1e6,           # qwen1.5 long-context rope base
    tie_embeddings=False,
    mlp_activation="silu",
)
