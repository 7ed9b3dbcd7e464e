"""Model zoo of the port: the decoder with GQA, MLA or Mamba-2 SSD
mixers (hybrids interleave them) and dense or fine-grained MoE FFNs
(params as nested dicts of f32 tensors, stacked per layer group as in
the JAX package)."""

from . import mamba2, moe
from .config import LayerSpec, ModelConfig
from .transformer import decode_step, init_cache, model_init, prefill

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "decode_step",
    "init_cache",
    "mamba2",
    "model_init",
    "moe",
    "prefill",
]
