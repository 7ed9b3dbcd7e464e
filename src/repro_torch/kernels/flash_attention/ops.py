"""Public entry point for the flash-attention kernels and their plain
PyTorch twin.

``flash_attention`` runs :func:`flash_attention_plain` for CPU tensors
and launches a CUDA kernel for CUDA tensors; there is no other path.
Which kernel is a plain function of dtype and head dim, :func:`_route`:

* ``"wgmma"`` — ``csrc/flash_attention_sm90.cu``: bf16/f16, both
  products on the tensor cores (wgmma, TMA, warp-specialised); D is
  padded with zeros to a multiple of 64;
* ``"tf32x3"`` — ``csrc/flash_attention_f32_sm90.cu``: f32, both
  products on the tensor cores, each split three ways in TF32 (a_lo b_hi
  + a_hi b_lo + a_hi b_hi), which keeps f32 accuracy where one TF32
  product would not: the TPU kernel computes f32 inputs in f32, and so
  does this route, within the f32 tolerance. D above 128 runs on a
  cluster of two blocks that split the head dim and exchange partial
  scores through distributed shared memory.

Every head dim the JAX entry takes (a multiple of 8 in [8, 256]) has a
route, and both load by TMA, so q, k and v must be 16-byte aligned. A
launch error raises; no route gives way to another or to the twin.
Every route keeps the JAX entry's contract: ``block_q``/``block_k``
default to 512, are capped at S, and must divide S (``ValueError``
otherwise), so callers behave alike on every backend. The kernels' own
64-row tiles mask the ragged edge and need not divide S.

``q_offset`` takes a block of the query rows: q holds ``Sq`` rows that
are rows ``q_offset .. q_offset + Sq - 1`` of k and v's ``Sk``-row
sequence, and the causal diagonal and the window edge fall where they
fall in the whole call (a rank of ``attn_seq_shard``, which holds a
block of the query sequence against all of its keys). The contract is
then the whole sequence's (the blocks divide ``Sk``); the rank's rows
need not fill whole blocks.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import NEG_INF, attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "attention_ref", "ROUTES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTES = ("wgmma", "tf32x3")
# route -> (source under csrc/, C entry point)
_KERNELS = {
    "wgmma": ("flash_attention_sm90", "flash_attention_sm90_launch"),
    "tf32x3": ("flash_attention_f32_sm90", "flash_attention_f32_sm90_launch"),
}
# The largest f32 head dim the tf32x3 kernel takes; above 128 it runs as
# a pair of blocks, each holding half the head dim.
TF32X3_MAX_D = 256

# The tf32x3 kernel's P fragment holds score columns (2c, 2c + 1) of each
# k8 slice where the TF32 A operand expects (c, c + 4); its pre-pass
# stores each group of 8 kv rows of V^T in this order instead, so that
# position j of the group holds kv row TF32X3_KV_ORDER[j].
TF32X3_KV_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _route(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches."""
    if dtype not in _DTYPES:
        raise TypeError(
            f"flash_attention: dtype {dtype}; the kernels take float32, bfloat16 "
            "or float16"
        )
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple of 8 in [8, 256]")
    return "tf32x3" if dtype == torch.float32 else "wgmma"


def _fn(route: str):
    source, entry = _KERNELS[route]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        if route == "tf32x3":  # + the two scratch pointers, no dtype
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, block_q, block_k, q_offset=0):
    """The blocks, capped at the sequence, after the JAX entry's checks:
    ``block_q`` the rank's (at most its ``Sq`` rows), ``block_k`` the
    keys'."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D) / (B, Hkv, S, D)")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}"
        )
    if H % Hkv:
        raise ValueError(f"heads {H} not a multiple of kv heads {Hkv}")
    if q_offset < 0 or q_offset + Sq > Sk:
        raise ValueError(f"q rows {q_offset}..{q_offset + Sq} are not rows of the {Sk} keys")
    block_q, block_k = min(block_q, Sk), min(block_k, Sk)
    if Sk % block_q or Sk % block_k:
        raise ValueError(f"seq {Sk} must be divisible by blocks {block_q}/{block_k}")
    return min(block_q, max(Sq, 1)), block_k


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
    q_offset: int = 0,
) -> torch.Tensor:
    """The kernel's plain twin: the Pallas schedule written out — per q
    block an online softmax over the kv blocks, f32 running max / sum /
    accumulator, the finite ``-1e30`` sentinel, kv blocks fully masked
    for the q block skipped, and a zero row where the sum stays 0. With
    ``q_offset`` the masks and the skips read each row's place in the
    sequence; the rank's last q block may be short."""
    block_q, block_k = _check(q, k, v, block_q, block_k, q_offset)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = float(D ** -0.5) if scale is None else float(scale)
    qg = q.float().reshape(B, Hkv, group, Sq, D)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, group, Sq, D), dtype=torch.float32, device=q.device)
    for q_start in range(0, Sq, block_q):
        qb = qg[:, :, :, q_start : q_start + block_q]
        bq, g0 = qb.shape[3], q_offset + q_start  # its rows and its first row's place
        rows = torch.arange(g0, g0 + bq, device=q.device)[:, None]
        m = torch.full((B, Hkv, group, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, group, bq, 1), device=q.device)
        acc = torch.zeros((B, Hkv, group, bq, D), device=q.device)
        for k_start in range(0, Sk, block_k):
            if causal and k_start > g0 + bq - 1:
                continue
            if window is not None and not k_start + block_k - 1 > g0 - window:
                continue
            s = torch.einsum(
                "bhgqd,bhkd->bhgqk", qb, kf[:, :, k_start : k_start + block_k]
            ) * scale
            cols = torch.arange(k_start, k_start + block_k, device=q.device)[None, :]
            mask = torch.ones((bq, block_k), dtype=torch.bool, device=q.device)
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
    return out.reshape(B, H, Sq, D).to(q.dtype)


def _launch(route: str, q, k, v, *, causal, window, scale, q_offset=0) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked CUDA tensors; counts the
    launch in ``flash_attention.launches`` and ``launches_by_route``, and
    an offset call (a block of the query rows) in ``offset_launches``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: the {route} route needs 16-byte aligned q, k, v")
    o = torch.empty_like(q)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, o)]
    tail = [B, H, Hkv, Sq, Sk, q_offset, D, int(causal), int(window is not None),
            int(window) if window is not None else 0, scale]
    if route == "tf32x3":
        # scratch of the split pre-pass: K's TF32 hi/lo parts, and V^T's
        # with the kv axis padded to a multiple of 32
        ks = torch.empty((B * Hkv, 2, Sk, D), dtype=torch.float32, device=q.device)
        vt = torch.empty((B * Hkv, 2, D, -(-Sk // 32) * 32), dtype=torch.float32,
                         device=q.device)
        ptrs += [ctypes.c_void_p(ks.data_ptr()), ctypes.c_void_p(vt.data_ptr())]
    else:
        tail.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = _fn(route)(*ptrs, *tail, ctypes.c_void_p(_build.raw_stream(q.device.index)))
    if err:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    if Sq != Sk or q_offset:
        flash_attention.offset_launches += 1
    return o


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
    q_offset: int = 0,
) -> torch.Tensor:
    """Blockwise attention, (B, H, Sq, D) x (B, Hkv, Sk, D)^2 -> (B, H,
    Sq, D); q's rows are rows ``q_offset ..`` of the keys' sequence
    (``Sq = Sk``, offset 0: the JAX entry's square call).

    CUDA tensors: the hand-written kernel that :func:`_route` names
    (f32 / bf16 / f16, D a multiple of 8 up to 256, contiguous and
    16-byte aligned inputs).
    CPU tensors: the plain twin :func:`flash_attention_plain`.
    Either way it raises under autograd (grad mode on and an input that
    requires grad): the kernel has no backward.
    """
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, scale=scale,
            block_q=block_q, block_k=block_k, q_offset=q_offset,
        )
    _check(q, k, v, block_q, block_k, q_offset)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: q, k, v must share one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
            "takes one of float32, bfloat16, float16 for all three"
        )
    D = q.shape[-1]
    route = _route(q.dtype, D)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    scale = float(D ** -0.5) if scale is None else float(scale)
    return _launch(route, q, k, v, causal=causal, window=window, scale=scale,
                   q_offset=q_offset)


flash_attention.launches = 0
flash_attention.offset_launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
