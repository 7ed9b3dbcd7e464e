"""Plain PyTorch oracle for blockwise (flash) attention.

Semantics: softmax(Q K^T * scale + mask) V with optional causal masking
and sliding-window attention (SWA, window counts how many past tokens a
query may attend to, inclusive of itself). GQA: K/V have ``num_kv_heads``
heads; query head h attends to kv head ``h // (H // H_kv)``.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset``: the queries are rows ``q_offset ..`` of the keys'
    sequence (a block of a longer query sequence; K/V may then be longer
    than Q), which the causal and window masks read."""
    B, H, S, D = q.shape
    T = k.shape[2]
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    group = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx.float()) * scale
    rows = q_offset + torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    return out.to(q.dtype)
