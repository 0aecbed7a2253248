"""MiniCPM-2B [arXiv:2404.06395] -- llama-like dense with depth-scaled
residuals (mup) and the WSD schedule (``launch.steps.default_opt_config``
picks it for this model, as the reference does).

40L d_model=2304 36H (kv=36 = MHA) d_ff=5760 vocab=122753.
"""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

_SCALE_DEPTH = 1.4

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    unit=(LayerSpec(FULL, DENSE),),
    residual_scale=_SCALE_DEPTH / (40 ** 0.5),
    tie_embeddings=True,
    mlp_activation="silu",
)
