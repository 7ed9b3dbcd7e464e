"""Shared neural-net layers (plain functions over param dicts).

Conventions, as in ``repro.models.layers``:
* params are nested dicts of f32 tensors; compute casts to bf16
  (``COMPUTE_DTYPE``) at the matmul boundary, norms/softmax in f32;
* initializers take an explicit ``torch.Generator`` and a device;
* all functions are shape-polymorphic over leading batch dims.

Tensor parallelism (Megatron-style, ``parallel.tp``): :func:`embed`,
:func:`unembed` and :func:`swiglu` take the ``model`` group over which
their params are split (``group=None``: whole params, no collective).
The embedding table is split by vocab rows, the SwiGLU's ``gate``/``up``
by columns and its ``down`` by rows; norms stay replicated, but for
Mamba-2's :func:`gated_rmsnorm`, whose scale is split with ``d_inner``
and whose statistic is summed over the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.parallel.tp import copy_to_tp, reduce_from_tp, sum_over_tp

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
    """RMSNorm with f32 variance and output in ``x``'s dtype;
    ``bf16=True`` is :class:`RMSNormBF16`."""
    if bf16:
        return RMSNormBF16.apply(params["scale"], x, eps)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# Elements of one f32 temporary of the bf16 norm (16 MiB): its rowwise
# sums run over blocks of rows, so no f32 (B,S,d) tensor is made.
_F32_BLOCK = 1 << 22


def _row_blocks(rows: int, d: int):
    step = max(1, _F32_BLOCK // d)
    return (slice(i, i + step) for i in range(0, rows, step))


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX's ``einsum("...d,...d->...", a, b, preferred_element_type=
    f32)[..., None]``: an f32 sum of the exact products of 16-bit
    values, one block of rows at a time."""
    d = a.shape[-1]
    a2, b2 = a.reshape(-1, d), b.reshape(-1, d)
    out = torch.empty((a2.shape[0], 1), dtype=torch.float32, device=a.device)
    for r in _row_blocks(a2.shape[0], d):
        out[r] = (a2[r].float() * b2[r].float()).sum(-1, keepdim=True)
    return out.reshape(a.shape[:-1] + (1,))


class RMSNormBF16(torch.autograd.Function):
    """RMSNorm whose forward and backward keep every (B,S,d) tensor in
    the input dtype; f32 appears only in rowwise scalars (the variance
    and the g·s·x reduction) and in temporaries of at most
    ``_F32_BLOCK`` elements — the port of ``repro.models.layers.
    _rmsnorm_bf16`` and its custom VJP, op for op."""

    @staticmethod
    def forward(ctx, scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
        inv = torch.rsqrt(_rowdot(x, x) / x.shape[-1] + eps)  # (..., 1) f32
        ctx.save_for_backward(scale, x, inv)
        return x * (inv.to(x.dtype) * scale.to(x.dtype))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        scale, x, inv = ctx.saved_tensors
        d = x.shape[-1]
        sb = scale.to(x.dtype)
        t = _rowdot(g * sb, x)  # rowwise sum_i g_i s_i x_i
        coeff = inv ** 3 * (t / d)
        dx = inv.to(x.dtype) * sb * g - x * coeff.to(x.dtype)
        # dscale: sum over rows of (g·x)·inv in f32
        gx, inv2 = (g * x).reshape(-1, d), inv.reshape(-1, 1)
        dscale = torch.zeros(d, dtype=torch.float32, device=x.device)
        for r in _row_blocks(gx.shape[0], d):
            dscale += (gx[r].float() * inv2[r]).sum(0)
        return dscale.to(scale.dtype), dx, None


def gated_rmsnorm(params: dict, x: torch.Tensor, z: torch.Tensor,
                  eps: float = 1e-5, group=None) -> torch.Tensor:
    """Mamba-2's RMSNorm(x * silu(z)), in f32, output in ``x``'s dtype.
    With ``group``, ``x``, ``z`` and the scale are this rank's block of
    ``d_inner``: the norm is still over the whole ``d_inner``, so each
    rank's sum of squares is summed over ``group`` (``sum_over_tp``)
    before the ``rsqrt``."""
    xf = x.float() * F.silu(z.float())
    if group is None:
        var = (xf * xf).mean(-1, keepdim=True)
    else:
        n = x.shape[-1] * dist.get_world_size(group)
        var = sum_over_tp((xf * xf).sum(-1, keepdim=True), group) / n
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, output in ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"table": normal(gen, (vocab, d), 0.02, device)}


def embed(params: dict, tokens: torch.Tensor, group=None) -> torch.Tensor:
    """bf16 rows of the table for ``tokens``. With ``group`` the table
    is this rank's block of vocab rows (group rank ``r`` holds ids
    ``[r·V, (r+1)·V)``): ids outside it read zeros, and the rows are
    summed over ``group``, so each id's row comes from the one rank
    that holds it, exactly."""
    # gather-then-cast: the same values as cast-then-gather, without a
    # bf16 copy of the whole table per call
    table = params["table"]
    if group is None:
        return cast(table[tokens])
    n = table.shape[0]
    local = tokens - dist.get_rank(group) * n
    inside = ((local >= 0) & (local < n))[..., None]
    rows = table[local.clamp(0, n - 1)]
    return reduce_from_tp(cast(torch.where(inside, rows, torch.zeros_like(rows))), group)


def unembed(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """Logits in f32 (loss numerics); with ``group``, this rank's block
    of the vocab (the table's rows it holds)."""
    return copy_to_tp(x.float(), group) @ params["table"].float().T


# ---------------------------------------------------------------------------
# Dense FFNs
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d: int, ff: int, device) -> dict:
    s_in, s_out = d ** -0.5, ff ** -0.5
    return {
        "gate": normal(gen, (d, ff), s_in, device),
        "up": normal(gen, (d, ff), s_in, device),
        "down": normal(gen, (ff, d), s_out, device),
    }


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ cast(w)`` with JAX's type promotion: f32 activations keep
    f32 (the bf16 weight is widened), bf16 ones compute in bf16."""
    w = cast(w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def swiglu(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """SwiGLU FFN; with ``group``, column-parallel ``gate``/``up`` and
    row-parallel ``down``, whose partial sums are reduced over it."""
    x = copy_to_tp(x, group)
    h = F.silu(matmul(x, params["gate"])) * matmul(x, params["up"])
    return reduce_from_tp(matmul(h, params["down"]), group)


def gelu_mlp_init(gen: torch.Generator, d: int, ff: int, device) -> dict:
    return {
        "fc1": normal(gen, (d, ff), d ** -0.5, device),
        "b1": torch.zeros((ff,), dtype=torch.float32, device=device),
        "fc2": normal(gen, (ff, d), ff ** -0.5, device),
        "b2": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def gelu_mlp(params: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """Whisper's FFN. ``jax.nn.gelu`` defaults to the tanh form, so this
    one uses it too (``F.gelu``'s default is the exact erf). With
    ``group``, column-parallel ``fc1``/``b1`` and row-parallel ``fc2``,
    whose partial sums are reduced over it before the whole ``b2`` is
    added once."""
    x = copy_to_tp(x, group)
    h = F.gelu(matmul(x, params["fc1"]) + cast(params["b1"]), approximate="tanh")
    return reduce_from_tp(matmul(h, params["fc2"]), group) + cast(params["b2"])


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs ([0:D/2], [D/2:D]) of ``x`` (..., S, H, D) by f32
    ``angles`` (..., S, D/2), shared by every head; ``x``'s dtype out."""
    D = x.shape[-1]
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., : D // 2].float(), x[..., D // 2 :].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(
    x: torch.Tensor,  # (..., S, H, D)
    positions: torch.Tensor,  # (..., S)
    theta: float,
) -> torch.Tensor:
    """Standard rotary embedding over the last dim (pairs split as
    [0:D/2], [D/2:D], llama convention)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)  # angles (..., S, D/2)


def apply_mrope(
    x: torch.Tensor,  # (B, S, H, D)
    positions: torch.Tensor,  # (3, B, S) — temporal / height / width
    theta: float,
    sections: tuple[int, int, int],
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency slots are split into
    three contiguous sections, each rotated by its own position stream
    (slot i reads stream ``repeat(arange(3), sections)[i]``); the
    rotate-half convention and f32 angles are :func:`apply_rope`'s."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to D/2 = {D // 2}")
    freqs = rope_freqs(D, theta, x.device)  # (D/2,)
    # each slot's stream, made on the device: a host-made index would be
    # a blocking copy in every call
    slot = torch.arange(D // 2, device=x.device)
    sec_ids = (slot >= sections[0]).long() + (slot >= sections[0] + sections[1]).long()
    pos = positions.float()[sec_ids]  # (D/2, B, S)
    return _rotate(x, pos.movedim(0, -1) * freqs)  # angles (B, S, D/2)
