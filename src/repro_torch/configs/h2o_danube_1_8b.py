"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    num_layers=24, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    rope_theta=1e4, sliding_window=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16, sliding_window=8,
)
