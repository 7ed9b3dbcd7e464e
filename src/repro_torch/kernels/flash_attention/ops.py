"""Public entry point for the flash-attention kernel
(``csrc/flash_attention.cu``) and its plain PyTorch twin.

``flash_attention`` runs :func:`flash_attention_plain` for CPU tensors
and launches the CUDA kernel for CUDA tensors; there is no other path.
Both keep the JAX entry's contract: ``block_q``/``block_k`` default to
512, are capped at S, and must divide S (``ValueError`` otherwise), so
callers behave alike on every backend. The CUDA kernel's own 64-row
tiles mask the ragged edge and need not divide S.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import NEG_INF, attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "attention_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D) / (B, Hkv, S, D)")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    block_q, block_k = min(block_q, S), min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(f"seq {S} must be divisible by blocks {block_q}/{block_k}")
    return block_q, block_k


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """The kernel's plain twin: the Pallas schedule written out — per q
    block an online softmax over the kv blocks, f32 running max / sum /
    accumulator, the finite ``-1e30`` sentinel, kv blocks fully masked
    for the q block skipped, and a zero row where the sum stays 0."""
    block_q, block_k = _check(q, k, v, block_q, block_k)
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = float(D ** -0.5) if scale is None else float(scale)
    qg = q.float().reshape(B, Hkv, group, S, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, group, S, D), dtype=torch.float32, device=q.device)
    for q_start in range(0, S, block_q):
        qb = qg[:, :, :, q_start : q_start + block_q]
        rows = torch.arange(q_start, q_start + block_q, device=q.device)[:, None]
        m = torch.full((B, Hkv, group, block_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, group, block_q, 1), device=q.device)
        acc = torch.zeros((B, Hkv, group, block_q, D), device=q.device)
        for k_start in range(0, S, block_k):
            if causal and k_start > q_start + block_q - 1:
                continue
            if window is not None and not k_start + block_k - 1 > q_start - window:
                continue
            s = torch.einsum(
                "bhgqd,bhkd->bhgqk", qb, kf[:, :, k_start : k_start + block_k]
            ) * scale
            cols = torch.arange(k_start, k_start + block_k, device=q.device)[None, :]
            mask = torch.ones((block_q, block_k), dtype=torch.bool, device=q.device)
            if causal:
                mask &= cols <= rows
            if window is not None:
                mask &= cols > rows - window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k_start : k_start + block_k]
            )
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully-masked rows -> 0
        out[:, :, :, q_start : q_start + block_q] = acc / l
    return out.reshape(B, H, S, D).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Blockwise attention, (B, H, S, D) x (B, Hkv, S, D)^2 -> (B, H, S, D).

    CUDA tensors: the hand-written kernel (f32 / bf16 / f16, D a
    multiple of 8 up to 256, contiguous inputs). CPU tensors: the plain
    twin :func:`flash_attention_plain`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale,
            block_q=block_q, block_k=block_k,
        )
    _check(q, k, v, block_q, block_k)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
            "takes one of float32, bfloat16, float16 for all three"
        )
    B, H, S, D = q.shape
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple of 8 in [8, 256]")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    scale = float(D ** -0.5) if scale is None else float(scale)
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
            ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(o.data_ptr()),
            B, H, k.shape[1], S, D, int(causal), int(window is not None),
            int(window) if window is not None else 0, scale, _DTYPES[q.dtype],
            _build.stream_ptr(q),
        )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
