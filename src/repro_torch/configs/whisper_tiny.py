"""Whisper-tiny — encoder-decoder, conv frontend STUB (the encoder
consumes precomputed frame embeddings (B, 1500, 384))
[arXiv:2212.04356; unverified]. GeLU FFN, learned positions."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    encoder_layers=4, encoder_seq_len=1500,
    pos_scheme="learned", max_position_embeddings=32768,
    ffn_activation="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-tiny-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    encoder_layers=2, encoder_seq_len=24,
    pos_scheme="learned", max_position_embeddings=32768,
    ffn_activation="gelu",
)
