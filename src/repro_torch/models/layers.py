"""Shared neural-net layers (plain functions over param dicts).

Conventions, as in ``repro.models.layers``:
* params are nested dicts of f32 tensors; compute casts to bf16
  (``COMPUTE_DTYPE``) at the matmul boundary, norms/softmax in f32;
* initializers take an explicit ``torch.Generator`` and a device;
* all functions are shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """``N(0, 1) * scale`` in f32, drawn from ``gen`` on ``device``."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(generator=gen).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5,
            bf16: bool = False) -> torch.Tensor:
    """RMSNorm with f32 variance and output in ``x``'s dtype."""
    if bf16:
        raise NotImplementedError("bf16_norm is not ported yet")
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"table": normal(gen, (vocab, d), 0.02, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # gather-then-cast: the same values as cast-then-gather, without a
    # bf16 copy of the whole table per call
    return cast(params["table"][tokens])


# ---------------------------------------------------------------------------
# Dense FFN
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d: int, ff: int, device) -> dict:
    s_in, s_out = d ** -0.5, ff ** -0.5
    return {
        "gate": normal(gen, (d, ff), s_in, device),
        "up": normal(gen, (d, ff), s_in, device),
        "down": normal(gen, (ff, d), s_out, device),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ cast(params["gate"])) * (x @ cast(params["up"]))
    return h @ cast(params["down"])


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(
    x: torch.Tensor,  # (..., S, H, D)
    positions: torch.Tensor,  # (..., S)
    theta: float,
) -> torch.Tensor:
    """Standard rotary embedding over the last dim (pairs split as
    [0:D/2], [D/2:D], llama convention)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., : D // 2].float(), x[..., D // 2 :].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)
