"""DeepSeek-MoE-16B — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066; hf]. kv=16 = num_heads (MHA). First layer dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    num_experts=64, num_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
    first_layer_dense=True, rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=8, num_shared_experts=2, moe_top_k=2, moe_d_ff=32,
    first_layer_dense=True,
)
