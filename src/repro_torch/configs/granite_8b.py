"""granite-8b [arXiv:2405.04324; llama-arch, code]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, remat="none",
)
