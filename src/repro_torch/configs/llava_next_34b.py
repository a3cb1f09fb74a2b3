"""llava-next-34b - exact assigned config [hf:llava-hf/llava-v1.6; vlm backbone, anyres frontend stubbed]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, n_patches=576, rope_theta=5e6,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, n_patches=8, remat="none",
)
