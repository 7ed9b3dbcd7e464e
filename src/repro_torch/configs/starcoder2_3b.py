"""StarCoder2-3B — dense GQA + RoPE [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    rope_theta=1e5,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-3b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, rope_theta=1e5,
)
