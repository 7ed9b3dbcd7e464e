"""Serving step builders — the serving part of ``repro.launch.steps``.

PyTorch runs eagerly, so a "step" is a plain closure over the config;
there is no compile cache to key.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.tree import map_tree


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, tokens, pos, cache):
        logits, new_cache = T.decode_step(params, cfg, tokens, pos, cache)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


def make_slot_prefill_step(cfg: ModelConfig, max_seq: int):
    """Per-slot prefill for continuous batching: one (1, S) prompt in,
    (first greedy token (1,), single-row cache) out. It never touches
    the other slots' state — the serve loop writes the returned cache
    row into the live batch cache with :func:`write_cache_slot`."""

    def slot_prefill_step(params, tokens):
        logits, cache = T.prefill(params, cfg, {"tokens": tokens}, max_seq)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return slot_prefill_step


def write_cache_slot(cache, one_cache, slot: int):
    """Write a batch=1 cache (from ``make_slot_prefill_step``) into row
    ``slot`` of a live multi-slot cache, in place; returns ``cache``.
    Leaves are (reps, B, ...)."""

    def put(full, one):
        full[:, slot] = one[:, 0].to(full.dtype)

    map_tree(put, cache, one_cache)
    return cache
