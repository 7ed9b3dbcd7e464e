"""Wire-compression numerics: symmetric int8 quantization + error
feedback — the port of ``repro.runtime.compression``.

``quantize``/``dequantize`` are the ONE definition of the lossy wire
format. The program executor (``core.chainwrite``) applies them per hop
when a program carries ``wire_dtype="int8"``, and the numpy oracle
(``core.chainwrite_ref._quantize_ref``) replays the same f32 arithmetic,
so the executor stays bit-exact against it, every per-hop rounding
included. The arithmetic is the JAX package's, step for step:

* ``max|x| / 128 + 1e-12`` in f32 (128 is a power of two, so the
  divide is exact however a backend evaluates it);
* the scale's low 7 mantissa bits masked off (``0xFFFFFF80``, i.e.
  ``-128`` as a signed int32) so every ``q * scale`` is exact in f32;
* TRUE division ``x / scale`` by a tensor scale — never a multiply by
  ``1 / scale``, which rounds differently (PyTorch's CUDA divide turns a
  Python-number divisor into such a multiply, so the divisor here is
  always a tensor);
* ``torch.round`` (half to even), clamp to ±127, int8.

Rounding, clamping and the dequantize multiply run in place on the one
f32 temporary they need, so quantizing a buffer of N f32 bytes holds
N + N/4 bytes of temporaries, not 2N; in-place ops round exactly as
their out-of-place forms.

:func:`quantize_rows` is the same format with one scale per row of a
stacked ``(L, ...)`` view: row ``d`` quantized alone is bitwise
``quantize(x[d])``. The executor quantizes each virtual device's buffer
this way.

:class:`ErrorFeedback` keeps the quantization residual and adds it back
before the next step's compression (EF-SGD).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, map_tree, unflatten

PyTree = Any

# 0xFFFFFF80 as a signed int32: keep 17 significant bits of the f32 scale.
_SCALE_MANTISSA_MASK = -128


def _mask_scale(scale: torch.Tensor) -> torch.Tensor:
    return (scale.view(torch.int32) & _SCALE_MANTISSA_MASK).view(torch.float32)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 ``q`` of ``x``'s shape, f32 0-dim ``scale``) — one scale
    for the whole tensor, computed in f32."""
    x = x.to(torch.float32)
    scale = _mask_scale(x.abs().amax() / 128.0 + 1e-12)
    return _to_int8(x / scale), scale


def _to_int8(t: torch.Tensor) -> torch.Tensor:
    return t.round_().clamp_(-127.0, 127.0).to(torch.int8)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row :func:`quantize` of a stacked ``(L, ...)`` view: returns
    ``q`` of ``x``'s shape and ``(L,)`` f32 scales."""
    x = x.to(torch.float32)
    L = x.shape[0]
    scale = _mask_scale(x.abs().reshape(L, -1).amax(1) / 128.0 + 1e-12)
    div = scale.reshape((L,) + (1,) * (x.dim() - 1))
    return _to_int8(x / div), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32, copy=True).mul_(scale)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: row ``d`` times ``scale[d]``."""
    return q.to(torch.float32, copy=True).mul_(scale.reshape((q.shape[0],) + (1,) * (q.dim() - 1)))


class ErrorFeedback:
    """Stateless helpers over an explicit residual tree."""

    @staticmethod
    def init(params: PyTree) -> PyTree:
        return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    @staticmethod
    def compress(grads: PyTree, residual: PyTree):
        """Returns (tree of (q, scale) tuples, new residual tree)."""
        qs, res = [], []
        for g, r in zip(leaves(grads), leaves(residual)):
            g = g.to(torch.float32) + r
            q, s = quantize(g)
            qs.append((q, s))
            res.append(g - dequantize(q, s))
        return unflatten(grads, qs), unflatten(grads, res)

    @staticmethod
    def decompress(qtree: PyTree) -> PyTree:
        return _map_pairs(lambda pair: dequantize(*pair), qtree)


def _map_pairs(fn, tree):
    if isinstance(tree, tuple) and len(tree) == 2 and all(
        isinstance(t, torch.Tensor) for t in tree
    ):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_pairs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pairs(fn, t) for t in tree)
    raise TypeError(f"expected a (q, scale) pair, got {type(tree).__name__}")
