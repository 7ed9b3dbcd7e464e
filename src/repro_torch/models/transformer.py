"""Model assembly for the dense-GQA decoder: layer blocks, stacked
layer groups, prefill and decode — the serving half of
``repro.models.transformer``.

Layer stacks are compiled into (pattern, repeat) groups
(``ModelConfig.layer_groups``) and each group's params are stacked along
a leading ``repeat`` dim, exactly the JAX package's layout, so carrying
weights across is a plain map. Where JAX scans over the stacked dim,
the port runs a Python loop over ``reps``. KV caches mirror the same
(group, position, stacked) structure.

Not ported yet (raise ``NotImplementedError``): MLA and Mamba mixers,
MoE and GeLU FFNs, cross-attention/encoder stacks, learned positions.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from . import attention as attn
from .config import LayerSpec, ModelConfig
from .layers import embed, embedding_init, rmsnorm, rmsnorm_init, swiglu, swiglu_init

Params = dict


def _check_spec(spec: LayerSpec, cfg: ModelConfig) -> None:
    if spec.mixer != "gqa":
        raise NotImplementedError(f"{spec.mixer} mixer is not ported yet")
    if spec.ffn == "moe":
        raise NotImplementedError("MoE FFN is not ported yet")
    if spec.ffn == "dense" and cfg.ffn_activation != "swiglu":
        raise NotImplementedError(f"{cfg.ffn_activation} FFN is not ported yet")
    if spec.cross_attention:
        raise NotImplementedError("cross-attention (encoder-decoder) is not ported yet")


def _check_model(cfg: ModelConfig) -> None:
    if cfg.pos_scheme in ("learned", "mrope") or cfg.is_encdec:
        raise NotImplementedError(f"pos_scheme={cfg.pos_scheme!r} / encoder is not ported yet")


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def layer_init(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, device) -> Params:
    _check_spec(spec, cfg)
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device)}
    p["mixer"] = attn.gqa_init(gen, cfg, device)
    if spec.ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, device)
    return p


def _ffn(params: Params, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if spec.ffn == "none":
        return x
    h = rmsnorm(params["norm2"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    return x + swiglu(params["ffn"], h)


def layer_prefill(
    params: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_seq: int,
) -> tuple[torch.Tensor, Params]:
    """Full-sequence layer that also emits its decode cache."""
    _check_spec(spec, cfg)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    h, cache = attn.gqa_prefill(params["mixer"], h, positions, cfg, max_seq)
    return _ffn(params, spec, cfg, x + h), cache


def layer_decode(
    params: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,
    cache: Params,
) -> tuple[torch.Tensor, Params]:
    """One-token layer; updates ``cache`` in place (see ``gqa_decode``)."""
    _check_spec(spec, cfg)
    h = rmsnorm(params["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    h, cache = attn.gqa_decode(params["mixer"], h, pos, cache, cfg)
    return _ffn(params, spec, cfg, x + h), cache


def layer_init_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, max_seq: int,
                     device) -> Params:
    _check_spec(spec, cfg)
    return attn.gqa_init_cache(cfg, batch, max_seq, device=device)


# ---------------------------------------------------------------------------
# Groups (loops over stacked layers)
# ---------------------------------------------------------------------------


def _stack(trees: list[dict]) -> dict:
    return {
        k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
        else torch.stack([t[k] for t in trees])
        for k in trees[0]
    }


def _index(tree: dict, r: int) -> dict:
    """Layer ``r`` of a stacked tree (views, no copy)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def groups_init(gen: torch.Generator, cfg: ModelConfig, device, groups=None) -> list[list[Params]]:
    groups = cfg.layer_groups() if groups is None else groups
    out = []
    for pattern, reps in groups:
        per_pos: list[list[Params]] = [[] for _ in pattern]
        for _ in range(reps):
            for pi, spec in enumerate(pattern):
                per_pos[pi].append(layer_init(gen, spec, cfg, device))
        out.append([_stack(ps) for ps in per_pos])
    return out


def groups_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                      groups=None) -> list[list[Params]]:
    groups = cfg.layer_groups() if groups is None else groups
    return [
        [
            _stack([layer_init_cache(spec, cfg, batch, max_seq, device) for _ in range(reps)])
            for spec in pattern
        ]
        for pattern, reps in groups
    ]


def groups_decode(
    gparams: list[list[Params]],
    caches: list[list[Params]],
    cfg: ModelConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    groups=None,
) -> tuple[torch.Tensor, list[list[Params]]]:
    """Decode through every group; each layer writes its K/V row into
    its slice of the stacked cache in place. Returns ``caches``."""
    groups = cfg.layer_groups() if groups is None else groups
    for (pattern, reps), stacked, cstacked in zip(groups, gparams, caches):
        for r in range(reps):
            for spec, p, c in zip(pattern, stacked, cstacked):
                x, _ = layer_decode(_index(p, r), spec, cfg, x, pos, _index(c, r))
    return x, caches


# ---------------------------------------------------------------------------
# Full model: init / prefill / decode
# ---------------------------------------------------------------------------


def model_init(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> Params:
    """Random f32 params from ``gen`` on ``device`` (default ``"cuda"``),
    nested as ``repro.models.transformer.model_init``'s."""
    device = resolve_device(device)
    _check_model(cfg)
    p: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "groups": groups_init(gen, cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model, device)
    return p


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    device = resolve_device(device)
    _check_model(cfg)
    return {"layers": groups_init_cache(cfg, batch, max_seq, device)}


def _head_table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"] if cfg.tie_embeddings else params["lm_head"])["table"]


def prefill(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt ``batch["tokens"]`` (B, S), build the decode
    cache, return last-token logits (B, V) in f32."""
    _check_model(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)

    caches: list[list[Params]] = []
    for (pattern, reps), stacked in zip(cfg.layer_groups(), params["groups"]):
        per_pos: list[list[Params]] = [[] for _ in pattern]
        for r in range(reps):
            for pi, (spec, p) in enumerate(zip(pattern, stacked)):
                x, c = layer_prefill(_index(p, r), spec, cfg, x, positions, max_seq)
                per_pos[pi].append(c)
        caches.append([_stack(cs) for cs in per_pos])

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    logits = x[:, -1].float() @ _head_table(params, cfg).float().T
    return logits, {"layers": caches}


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B,) current token ids
    pos: torch.Tensor,  # scalar int32 — or (B,) per-slot absolute positions
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One decode step: returns (logits (B, V), cache).

    With a ``(B,)`` ``pos`` every batch row advances at its own absolute
    position (continuous batching). The cache is updated in place and
    returned."""
    _check_model(cfg)
    x = embed(params["embed"], tokens[:, None])  # (B, 1, d)
    x, _ = groups_decode(params["groups"], cache["layers"], cfg, x, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    logits = x[:, 0].float() @ _head_table(params, cfg).float().T
    return logits, cache


__all__ = [
    "decode_step",
    "groups_decode",
    "groups_init",
    "groups_init_cache",
    "init_cache",
    "layer_decode",
    "layer_init",
    "layer_prefill",
    "model_init",
    "prefill",
]
