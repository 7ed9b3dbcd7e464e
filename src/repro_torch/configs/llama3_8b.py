"""Llama-3-8B — dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    rope_theta=5e5,
)

SMOKE_CONFIG = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16, rope_theta=5e5,
)
