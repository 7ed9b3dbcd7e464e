"""Yi-6B — llama-architecture dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5e6,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-6b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, rope_theta=5e6,
)
