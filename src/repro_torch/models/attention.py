"""GQA attention mixer (+RoPE, SWA ring-buffer caches) — the GQA part
of ``repro.models.attention``.

``gqa_apply``/``gqa_prefill`` handle the full-sequence path (through the
flash kernel when ``cfg.attn_impl == "flash"``) and ``gqa_decode`` the
single-token path with a KV cache. KV caches for SWA archs are ring
buffers of ``window`` slots. The MLA mixer is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.chunked import attention_chunked
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

from .config import ModelConfig
from .layers import apply_rope, cast, normal

NEG_INF = -1e30


def _full_attention(qt, kt, vt, cfg: ModelConfig, *, causal: bool):
    """Dispatch on cfg.attn_impl: 'reference' (materialized S² scores),
    'chunked' (online-softmax loop over KV chunks), or 'flash' (the CUDA
    kernel; its plain twin on CPU tensors)."""
    if cfg.attn_impl == "flash":
        return flash_attention(
            qt.contiguous(), kt.contiguous(), vt.contiguous(),
            causal=causal, window=cfg.sliding_window,
        )
    if cfg.attn_impl == "chunked":
        return attention_chunked(
            qt, kt, vt, causal=causal, window=cfg.sliding_window,
            chunk=cfg.attn_chunk,
        )
    return attention_ref(qt, kt, vt, causal=causal, window=cfg.sliding_window)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": normal(gen, (d, H * Dh), d ** -0.5, device),
        "wk": normal(gen, (d, Hkv * Dh), d ** -0.5, device),
        "wv": normal(gen, (d, Hkv * Dh), d ** -0.5, device),
        "wo": normal(gen, (H * Dh, d), (H * Dh) ** -0.5, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=device)
    return p


def _project_qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ cast(params["wq"])
    k = x @ cast(params["wk"])
    v = x @ cast(params["wv"])
    if cfg.qkv_bias:
        q = q + cast(params["bq"])
        k = k + cast(params["bk"])
        v = v + cast(params["bv"])
    return (
        q.reshape(B, S, H, Dh),
        k.reshape(B, S, Hkv, Dh),
        v.reshape(B, S, Hkv, Dh),
    )


def _rope_qk(q, k, positions, cfg: ModelConfig):
    if cfg.pos_scheme == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    if cfg.pos_scheme == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # 'none': no positional rotation (learned PE lives at the embedding).
    return q, k


def gqa_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence GQA (training / prefill), no cache."""
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B,H,S,D)
    out = _full_attention(qt, kt, vt, cfg, causal=causal)
    B, S = x.shape[:2]
    out = out.transpose(1, 2).reshape(B, S, -1)
    return out @ cast(params["wo"])


def gqa_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention that also emits the decode KV cache
    (ring-buffer layout for SWA archs)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = _full_attention(qt, kt, vt, cfg, causal=True)
    out = out.transpose(1, 2).reshape(B, S, -1) @ cast(params["wo"])

    slots = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    cache = gqa_init_cache(cfg, B, max_seq, device=x.device)
    keep = torch.arange(max(0, S - slots), S, device=x.device)  # last `slots` tokens
    slot_ids = keep % slots
    cache["k"][:, slot_ids] = k[:, keep].to(torch.bfloat16)
    cache["v"][:, slot_ids] = v[:, keep].to(torch.bfloat16)
    return out, cache


def gqa_init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    slots = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,  # scalar int32 — or (B,) per-slot absolute positions
    cache: dict,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode with (ring-buffer for SWA) KV cache.

    ``pos`` is either a scalar (every row at the same absolute position)
    or a ``(B,)`` vector of per-slot positions (continuous batching).
    The new K/V rows are written into ``cache`` in place — the port
    keeps one cache instead of copying it every token — and ``cache`` is
    returned."""
    B = x.shape[0]
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, x, cfg)  # (B,1,*,Dh)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_slot = pos.dim() == 1
    pos_b = pos[:, None] if per_slot else pos.reshape(1, 1).expand(B, 1)
    q, k = _rope_qk(q, k, pos_b, cfg)

    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    rows = torch.arange(B, device=x.device)
    slot_b = (pos_b[:, 0] % slots).long()  # ring-buffer slot per row
    ck[rows, slot_b] = k[:, 0].to(ck.dtype)
    cv[rows, slot_b] = v[:, 0].to(cv.dtype)

    group = H // Hkv
    qh = q[:, 0].reshape(B, Hkv, group, Dh)
    # bf16 operands, f32 products and sums (the JAX einsum's
    # preferred_element_type=f32): upcast, since a bf16 einsum would
    # round its result to bf16.
    scores = torch.einsum(
        "bhgd,bshd->bhgs", qh.to(ck.dtype).float(), ck.float()
    ) * (Dh ** -0.5)
    # Valid slots: written positions only (a ring buffer is fully valid
    # once wrapped; before wrapping, slots > pos are empty).
    slot_ids = torch.arange(slots, device=x.device)
    valid = (pos_b >= slots) | (slot_ids[None, :] <= pos_b)  # (B, slots)
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(cv.dtype).float(), cv.float())
    out = out.reshape(B, 1, H * Dh).to(x.dtype)
    return out @ cast(params["wo"]), cache
