"""grok-1-314b [hf:xai-org/grok-1; 8e top-2]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab=131072, head_dim=128, n_experts=8, top_k=2,
    expert_split=2,  # 8 experts -> 16 sub-experts, the 16-way mesh axis
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, n_experts=4, top_k=2, remat="none",
)
