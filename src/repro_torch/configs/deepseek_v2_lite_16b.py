"""DeepSeek-V2-Lite (16B) — MLA (kv_lora 512) + fine-grained MoE
[arXiv:2405.04434; hf].

Assignment config line: "MoE 64e top-6" (d_ff 1408); the descriptive
note mentions 160 routed experts — we follow the config line
(64 routed + 2 shared, top-6), recorded in DESIGN.md.
First layer uses a dense FFN (width 10944), as in the release.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400,
    attention="mla", kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    num_experts=64, num_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
    first_layer_dense=True, rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    attention="mla", kv_lora_rank=32,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    num_experts=8, num_shared_experts=2, moe_top_k=2, moe_d_ff=32,
    first_layer_dense=True,
)
