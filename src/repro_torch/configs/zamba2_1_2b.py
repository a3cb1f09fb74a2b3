"""zamba2-1.2b - exact assigned config [arXiv:2411.15242; mamba2 + shared attn blocks]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6, window=4096,  # windowed shared-attn KV for long-context serving
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, ssm_state=16, ssm_expand=2, ssm_chunk=16,
    attn_every=2, window=64, remat="none",
)
