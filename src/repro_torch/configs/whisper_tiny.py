"""whisper-tiny - exact assigned config [arXiv:2212.04356; enc-dec, conv frontend stubbed]."""
from repro_torch.models.config import ModelConfig


CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, enc_layers=4, enc_seq=1500, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-tiny-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, enc_layers=2, enc_seq=32, tie_embeddings=True, remat="none",
)
