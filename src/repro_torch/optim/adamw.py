"""AdamW with warmup + cosine schedule and global-norm clipping — the
port of ``repro.optim.adamw``, on trees of tensors.

The arithmetic is the JAX package's, in f32 and in its order: clip by
the global norm with ``+1e-9``, moments ``b1·m + (1-b1)·g`` and
``b2·v + (1-b2)·g·g``, bias correction ``1 - b ** step`` with the step
as f32, weight decay inside the update. ``step`` is an int32 tensor.

``update`` writes the new moments and params into the buffers of
``state`` and ``params``, leaf by leaf, as the JAX step donates them,
so a step holds one copy of the optimizer state and the params, not
two. :func:`zero1_specs` gives the ZeRO-1 partition specs of the
optimizer state (each leaf also split over the data axis), as JAX's.

Under tensor parallelism each rank holds shards of some leaves: the
clipping norm is still the whole logical tree's (:func:`global_norm`
with the ``model`` group and which leaves are split), so every rank of
a TP group clips by the same factor JAX's GSPMD step does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.parallel.spec import P
from repro_torch.tree import leaves, map_tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * peak."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps),
        0.0,
        1.0,
    )
    cos = cfg.peak_lr * (
        cfg.min_lr_ratio
        + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: PyTree) -> dict:
    """Zero f32 moments on each param's device, and step 0 (int32)."""
    zeros = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = leaves(params)[0].device
    return {
        "mu": zeros,
        "nu": map_tree(torch.zeros_like, zeros),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: PyTree, *, group=None, split: PyTree | None = None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree``. With a TP ``group`` and
    ``split`` (a tree of bools: the leaf is this rank's shard of a leaf
    split over ``group``), the norm of the logical tree: the split
    leaves' squares summed over ``group``, each whole leaf counted once."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    if group is None:
        return torch.sqrt(sum(sq))
    from repro_torch.parallel.tp import all_reduce

    flags = leaves(split)
    zero = sq[0].new_zeros(())
    shards = all_reduce(sum((q for q, f in zip(sq, flags) if f), zero), group)
    return torch.sqrt(shards + sum((q for q, f in zip(sq, flags) if not f), zero))


def update(
    cfg: OptConfig,
    grads: PyTree,
    state: dict,
    params: PyTree,
    *,
    group=None,
    split: PyTree | None = None,
) -> tuple[PyTree, dict, dict]:
    """One AdamW step, written into the buffers of ``params`` and
    ``state``. Returns (params, state, metrics). ``group`` and ``split``
    reach :func:`global_norm` (tensor parallelism)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, group=group, split=split)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    for g, m, v, p in zip(leaves(grads), leaves(state["mu"]), leaves(state["nu"]),
                          leaves(params)):
        # each in-place op rounds as its out-of-place form in the JAX
        # expression does, so a leaf needs ~3 temporaries of its size
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)  # b1·m + (1-b1)·g
        v.mul_(b2).add_((1 - b2) * g * g)  # b2·v + (1-b2)·g·g
        del g
        u = m / bc1  # mhat / (sqrt(vhat) + eps) + wd·p, times lr
        u.div_((v / bc2).sqrt_().add_(cfg.eps)).add_(cfg.weight_decay * p).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(u)
        else:
            p.copy_(p.to(torch.float32).sub_(u))
    state["step"].copy_(step)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO-1 partition specs
# ---------------------------------------------------------------------------


def zero1_leaf_spec(param_spec, shape: tuple[int, ...], data_size: int,
                    axis: str = "data") -> P:
    """Additionally shard an optimizer leaf over the data axis: pick the
    first dim that is divisible by the data-axis size and not already
    sharded. Falls back to the param's own spec."""
    existing = tuple(param_spec) if param_spec is not None else (None,) * len(shape)
    existing = existing + (None,) * (len(shape) - len(existing))
    for i, dim in enumerate(shape):
        if existing[i] is None and dim % data_size == 0 and dim >= data_size:
            new = list(existing)
            new[i] = axis
            return P(*new)
    return P(*existing)


def zero1_specs(param_specs: PyTree, params: PyTree, data_size: int) -> dict:
    """Specs for the optimizer state tree (:func:`init`'s) given the
    param specs and the params (meta tensors will do)."""
    mu_specs = map_tree(lambda spec, p: zero1_leaf_spec(spec, tuple(p.shape), data_size),
                        param_specs, params)
    return {"mu": mu_specs, "nu": mu_specs, "step": P()}


__all__ = ["OptConfig", "global_norm", "init", "schedule", "update", "zero1_leaf_spec",
           "zero1_specs"]
