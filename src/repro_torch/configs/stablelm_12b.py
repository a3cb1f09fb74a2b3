"""stablelm-12b [hf:stabilityai/stablelm-2-12b]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, head_dim=160,
)

SMOKE = ModelConfig(
    name="stablelm-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, remat="none",
)
