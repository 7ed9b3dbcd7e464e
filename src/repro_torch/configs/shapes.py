"""Assigned input shapes × applicability, and meta-tensor input specs —
the port of ``repro.configs.shapes``.

Four shapes per architecture (40 cells):
  train_4k     seq 4096  × global_batch 256   -> train_step
  prefill_32k  seq 32768 × global_batch 32    -> prefill_step
  decode_32k   KV 32768  × global_batch 128   -> serve_step (1 new token)
  long_500k    KV 524288 × global_batch 1     -> serve_step (1 new token)

``long_500k`` requires a sub-quadratic *cache working set*: it runs for
SSM (mamba2: O(1) state), hybrid (jamba) and SWA (h2o-danube: ring
buffer = window) archs, and is skipped for pure full-attention archs.

Where JAX builds ``jax.ShapeDtypeStruct`` stand-ins, :func:`input_specs`
builds tensors on the ``meta`` device: shapes and dtypes, no storage.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic cache working set)
LONG_CONTEXT_ARCHS = {"mamba2-2.7b", "jamba-v0.1-52b", "h2o-danube-1.8b"}


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 512k dense-KV decode skipped"
    return True, ""


def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Meta-tensor stand-ins for every model input of this cell: the
    batch of a train or prefill step (the vlm stub frontend feeds
    ``embeds`` and M-RoPE ``positions``, the encoder-decoder's feeds
    ``enc_frames``), or the tokens, position and cache of a decode
    step."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        batch: dict = {}
        if cfg.family == "vlm":  # stub frontend: precomputed embeddings
            batch["embeds"] = _f((B, S, cfg.d_model), bf16)
            batch["positions"] = _f((3, B, S), i32)
        else:
            batch["tokens"] = _f((B, S), i32)
        if cfg.is_encdec:  # stub conv frontend: precomputed frames
            batch["enc_frames"] = _f((B, cfg.encoder_seq_len, cfg.d_model), bf16)
        if shape.kind == "train":
            batch["labels"] = _f((B, S), i32)
            return {"batch": batch}
        return {"batch": batch, "max_seq": S}
    # decode: one new token against a seq_len-deep cache
    from repro_torch.models import transformer as T

    return {
        "tokens": _f((B,), i32),
        "pos": _f((), i32),
        "cache": T.init_cache(cfg, B, S, device="meta"),
    }
