"""Model zoo of the port: the decoder with GQA or MLA attention and
dense or fine-grained MoE FFNs (params as nested dicts of f32 tensors,
stacked per layer group as in the JAX package)."""

from . import moe
from .config import LayerSpec, ModelConfig
from .transformer import decode_step, init_cache, model_init, prefill

__all__ = [
    "LayerSpec",
    "ModelConfig",
    "decode_step",
    "init_cache",
    "model_init",
    "moe",
    "prefill",
]
