"""gemma3-27b [hf:google/gemma-3-27b; 5:1 local:global, 128k]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab=262144, head_dim=128, window=1024, local_global_ratio=5,
    rope_theta=10000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, window=32, local_global_ratio=5,
    tie_embeddings=True, remat="none",
)
