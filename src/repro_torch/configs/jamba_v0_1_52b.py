"""Jamba-v0.1 (52B) — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer [arXiv:2403.19887; hf]. No positional encoding
(the Mamba layers carry position)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    num_experts=16, moe_top_k=2, moe_d_ff=14336, moe_layer_stride=2,
    attn_period=8, attn_offset=4, pos_scheme="none",
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_ngroups=8,
    ssm_conv=4, ssm_chunk=128,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=4, moe_top_k=2, moe_d_ff=64, moe_layer_stride=2,
    attn_period=8, attn_offset=4, pos_scheme="none",
    ssm_state=8, ssm_headdim=8, ssm_expand=2, ssm_ngroups=2,
    ssm_conv=4, ssm_chunk=8,
)
