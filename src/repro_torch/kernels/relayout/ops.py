"""Public entry points for the relayout kernel (``csrc/relayout.cu``).

``relayout`` runs the plain twin :func:`.ref.relayout_ref` for a CPU
tensor and launches the CUDA kernel for a CUDA tensor; there is no other
path.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import blocked_to_dense, dense_to_blocked, parse_layout, relayout_ref

__all__ = [
    "relayout",
    "relayout_str",
    "relayout_ref",
    "parse_layout",
    "dense_to_blocked",
    "blocked_to_dense",
]


def _lib() -> ctypes.CDLL:
    lib = _build.load("relayout")
    fn = lib.relayout_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong] * 6 + [
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _unit_bytes(elsize: int, sbn: int, dbn: int, *ptrs: int) -> int:
    """Widest load/store unit (<= 16 B) that divides both block rows in
    bytes and the alignment of every pointer."""
    for unit in (16, 8, 4, 2, 1):
        if (
            unit % elsize == 0
            and (sbn * elsize) % unit == 0
            and (dbn * elsize) % unit == 0
            and all(p % unit == 0 for p in ptrs)
        ):
            return unit
    return elsize


def relayout(
    x: torch.Tensor,
    shape: tuple[int, int],
    src_block: tuple[int, int],
    dst_block: tuple[int, int],
) -> torch.Tensor:
    """Blocked(src_block) -> blocked(dst_block) layout transform.

    ``x``: (M//sbm, N//sbn, sbm, sbn). Returns (M//dbm, N//dbn, dbm, dbn)
    in ``x``'s dtype, bit-identical to :func:`relayout_ref`.
    """
    M, N = shape
    sbm, sbn = src_block
    dbm, dbn = dst_block
    if (M % sbm, N % sbn, M % dbm, N % dbn) != (0, 0, 0, 0):
        raise ValueError(f"blocks {src_block}/{dst_block} must divide {shape}")
    if tuple(x.shape) != (M // sbm, N // sbn, sbm, sbn):
        raise ValueError(
            f"x has shape {tuple(x.shape)}, expected {(M // sbm, N // sbn, sbm, sbn)}"
        )
    if x.device.type == "cpu":
        return relayout_ref(x, shape, src_block, dst_block)
    if x.device.type != "cuda":
        raise ValueError(f"relayout: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("relayout: x must be contiguous")
    out = torch.empty((M // dbm, N // dbn, dbm, dbn), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    es = x.element_size()
    unit = _unit_bytes(es, sbn, dbn, x.data_ptr(), out.data_ptr())
    per = unit // es
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.relayout_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            M, N // per, sbm, sbn // per, dbm, dbn // per, unit,
            _build.stream_ptr(x),
        )
    if err:
        raise RuntimeError(f"relayout kernel launch failed: CUDA error {err}")
    relayout.launches += 1
    return out


relayout.launches = 0


def relayout_str(
    x: torch.Tensor,
    shape: tuple[int, int],
    src_layout: str,
    dst_layout: str,
) -> torch.Tensor:
    """Same, with the paper's layout strings (e.g. ``"MNM16N8"``)."""
    return relayout(x, shape, parse_layout(src_layout), parse_layout(dst_layout))
