"""Plain PyTorch oracle for the relayout (DSE layout-transform) kernel.

A *blocked layout* ``(bm, bn)`` stores an (M, N) matrix as the 4-D array
``(M//bm, N//bn, bm, bn)`` — the paper's ``MNM16N8`` notation is block
height 16 × block width 8 (elements within a block are row-major, blocks
are row-major over the block grid). This oracle defines the semantics
the CUDA kernel must match bit for bit.
"""

from __future__ import annotations

import re

import torch

_LAYOUT_RE = re.compile(r"^MNM(\d+)N(\d+)$")


def parse_layout(layout: str) -> tuple[int, int]:
    """Parse the paper's layout string, e.g. ``"MNM16N8"`` -> (16, 8)."""
    m = _LAYOUT_RE.match(layout)
    if not m:
        raise ValueError(f"unrecognized layout string: {layout!r}")
    return int(m.group(1)), int(m.group(2))


def blocked_to_dense(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(M//bm, N//bn, bm, bn) blocked -> (M, N) dense."""
    mb, nb, bm, bn = x.shape
    M, N = shape
    if mb * bm != M or nb * bn != N:
        raise ValueError(f"blocked shape {tuple(x.shape)} does not tile {shape}")
    return x.permute(0, 2, 1, 3).reshape(M, N)


def dense_to_blocked(x: torch.Tensor, block: tuple[int, int]) -> torch.Tensor:
    """(M, N) dense -> (M//bm, N//bn, bm, bn) blocked (contiguous)."""
    M, N = x.shape
    bm, bn = block
    if M % bm or N % bn:
        raise ValueError(f"block {block} does not divide {tuple(x.shape)}")
    return x.reshape(M // bm, bm, N // bn, bn).permute(0, 2, 1, 3).contiguous()


def relayout_ref(
    x: torch.Tensor,
    shape: tuple[int, int],
    src_block: tuple[int, int],
    dst_block: tuple[int, int],
) -> torch.Tensor:
    """Oracle: blocked(src) -> dense -> blocked(dst)."""
    return dense_to_blocked(blocked_to_dense(x, shape), dst_block)
