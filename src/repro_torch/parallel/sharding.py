"""Batch layouts for the data-parallel split — the port of
``repro.parallel.sharding.batch_pspecs``.

The port has no ``PartitionSpec``: its DP ranks are rows of a stacked
view on one card, so what a batch leaf's spec says to the split is which
axis holds the batch. ``batch_pspecs`` returns that axis per leaf (where
JAX returns ``P(BATCH_AXES, ...)``): M-RoPE ``positions`` are
(3, B, S), batch axis 1; every other leaf has it first. The param,
optimizer and cache specs need a tensor-parallel mesh, which the port
does not have yet.
"""

from __future__ import annotations

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig


def batch_pspecs(cfg: ModelConfig, shape: Shape) -> dict[str, int]:
    """The batch axis of each leaf of a train or prefill batch of
    ``cfg`` at ``shape`` (for ``split_batch``; ``make_train_step``
    takes its train batch's from here)."""
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    out: dict[str, int] = {}
    if cfg.family == "vlm":
        out["embeds"] = 0
        out["positions"] = 1
    else:
        out["tokens"] = 0
    if cfg.is_encdec:
        out["enc_frames"] = 0
    if shape.kind == "train":
        out["labels"] = 0
    return out


__all__ = ["batch_pspecs"]
