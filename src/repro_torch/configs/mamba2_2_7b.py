"""Mamba2-2.7B — attention-free SSD (state-space duality)
[arXiv:2405.21060; unverified]. d_inner = 2*2560 = 5120, 80 heads of 64,
state 128."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    ssm_conv=4, ssm_chunk=128,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=8, ssm_headdim=8, ssm_expand=2, ssm_ngroups=1,
    ssm_conv=4, ssm_chunk=8,
)
