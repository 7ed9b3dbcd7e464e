"""Chunked (online-softmax) attention in plain PyTorch — the twin of
``repro.kernels.flash_attention.chunked.attention_chunked``.

A loop over KV chunks with the same O(S·chunk) memory profile as the
flash kernel; supports GQA (grouped heads without materializing repeated
K/V), causal masking and sliding windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_chunked(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    chunk: int = 1024,
) -> torch.Tensor:
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    group = H // Hkv
    scale = D ** -0.5 if scale is None else scale

    C = min(chunk, S)
    pad = (-S) % C
    nc = (S + pad) // C
    if pad:  # pad K/V with masked-out slots
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))

    qg = (q.float() * scale).reshape(B, Hkv, group, S, D)
    rows = torch.arange(S, device=q.device)[:, None]  # (S, 1)
    m = torch.full((B, Hkv, group, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, group, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, group, S, D), dtype=torch.float32, device=q.device)
    for c in range(nc):
        start = c * C
        kb = k[:, :, start : start + C].float()
        vb = v[:, :, start : start + C].float()
        s = torch.einsum("bhgsd,bhcd->bhgsc", qg, kb)  # (B,Hkv,g,S,C)
        cols = start + torch.arange(C, device=q.device)[None, :]  # (1, C)
        mask = cols < S  # padding
        if causal:
            mask = mask & (cols <= rows)
        if window is not None:
            mask = mask & (cols > rows - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgsc,bhcd->bhgsd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully-masked rows -> 0
    out = (acc / l).reshape(B, H, S, D)
    return out.to(q.dtype)
