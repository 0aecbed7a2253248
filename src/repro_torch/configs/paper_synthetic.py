"""The paper's own synthetic workload "architecture" (paper §5): a small
dense model, exposed so ``get("paper-synthetic")`` selects it."""
from repro_torch.models.config import DENSE, FULL, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="paper-synthetic",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=1024,
    vocab_size=1024,
    unit=(LayerSpec(FULL, DENSE),),
    param_dtype="float32",
    compute_dtype="float32",
)
