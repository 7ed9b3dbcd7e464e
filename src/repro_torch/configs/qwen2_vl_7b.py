"""Qwen2-VL-7B — M-RoPE, dynamic-resolution ViT frontend (STUB: the
backbone consumes precomputed patch/token embeddings)
[arXiv:2409.12191; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    rope_theta=1e6, pos_scheme="mrope", mrope_sections=(16, 24, 24),
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    pos_scheme="mrope", mrope_sections=(2, 3, 3), qkv_bias=True,
)
