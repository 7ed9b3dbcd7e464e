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

ZeRO-1 in the process form (one rank per process, a live ``data``
axis): each rank holds only its block of ``mu`` and ``nu`` (``init``
with ``specs=``/``mesh=``), and :func:`update_zero1` clips by the norm
of the whole reduced grads, updates the rank's block of each param with
its moments, then all-gathers the blocks over the ``data`` group back
into the param: the all-gather GSPMD inserts after JAX's partitioned
update. :data:`gather_counter` counts the bytes that gather moves to a
rank.

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
from repro_torch.tree import leaves, map_tree, unflatten

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


def init(params: PyTree, *, specs: dict | None = None, mesh=None) -> dict:
    """Zero f32 moments on each param's device, and step 0 (int32).
    With ``specs`` (the optimizer state's, ``{"mu", "nu", "step"}``, as
    ``parallel.sharding.state_specs`` gives them) and a process
    ``mesh``, each moment is this rank's ZeRO-1 block of its param
    (:func:`zero1_block`'s shape), allocated at that size."""
    if specs is None:
        zeros = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    else:
        zeros = map_tree(lambda p, s: torch.zeros(_block_shape(p, s, mesh), dtype=torch.float32,
                                                  device=p.device), params, specs["mu"])
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
    return _apply(cfg, grads, state, params, global_norm(grads, group=group, split=split))


def _apply(cfg: OptConfig, grads: PyTree, state: dict, params: PyTree,
           gnorm: torch.Tensor) -> tuple[PyTree, dict, dict]:
    """The update of :func:`update` with the clipping norm given."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
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
# ZeRO-1 in the process form
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GatherCounter:
    """Bytes the ZeRO-1 param gather moved to this process: the other
    ranks' blocks it received, ``(dp - 1) / dp`` of every leaf that
    ``data`` splits."""

    bytes: int = 0

    def reset(self) -> None:
        self.bytes = 0


gather_counter = GatherCounter()


def _data_dim(spec, mesh) -> int | None:
    """The dim of a leaf that ``spec`` splits over the live ``data`` axis
    of ``mesh`` (at most one: ``zero1_leaf_spec`` adds one), or None."""
    from repro_torch.parallel.sharding import split_axes

    dims = [d for d, e in enumerate(spec) if "data" in split_axes(e, mesh)]
    return dims[0] if dims else None


def zero1_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's ZeRO-1 block (a view) of ``x``, its shard of a param
    or grad leaf: ``x`` cut along the dim ``spec`` (the leaf's moment
    spec) splits over ``data``, by the rank's ``data`` coordinate. ``x``
    itself where ``data`` splits nothing, or on a mesh without
    ``coords`` (the stacked view)."""
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.parallel.spec import keep_axes

    return shard_tree(x, keep_axes(spec, ("data",)), mesh)


def _block_shape(p, spec, mesh) -> tuple[int, ...]:
    return tuple(zero1_block(torch.empty(p.shape, device="meta"), spec, mesh).shape)


def _gather_blocks(p: torch.Tensor, block: torch.Tensor, dim: int, group) -> None:
    """All-gather every rank's ``block`` of ``p`` along ``dim`` over
    ``group`` into ``p``'s own buffer (group rank order = block order).
    Where the blocks are contiguous runs of ``p`` (nothing but unit dims
    before ``dim``) the collective writes straight into ``p``; else the
    blocks land in one buffer of ``p``'s size, copied in. A CUDA tensor
    goes to the backend as it is (gloo stages it through pinned host
    memory itself: 1.16 s for 1 GiB between two ranks on one H100,
    against 2.01 s staged by hand through pageable memory)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_counter.bytes += (n - 1) * block.numel() * block.element_size()
    direct = p.is_contiguous() and math.prod(p.shape[:dim]) == 1
    out = p.view(-1) if direct else p.new_empty((n * block.numel(),))
    gather(out, block.clone(memory_format=torch.contiguous_format).view(-1), group=group)
    if not direct:
        p.unflatten(dim, (n, p.shape[dim] // n)).copy_(
            out.view((n,) + tuple(block.shape)).movedim(0, dim))


def update_zero1(
    cfg: OptConfig,
    grads: PyTree,
    state: dict,
    params: PyTree,
    *,
    specs: PyTree,
    mesh,
    group=None,
    split: PyTree | None = None,
    spans=None,
) -> tuple[PyTree, dict, dict]:
    """One AdamW step of a ZeRO-1 rank: ``grads`` and ``params`` are the
    rank's whole leaves (its TP shards under tensor parallelism), the
    moments of ``state`` its blocks by ``specs`` (the moments' specs,
    ``opt_pspecs``' ``"mu"``). Clips by the global norm of the whole
    ``grads`` (``group`` and ``split`` as in :func:`update`), writes
    each param's block as :func:`update` writes the whole leaf, element
    for element in the same f32 order (so a block is bit for bit that
    slice of the unsharded update), then all-gathers the blocks over
    the ``data`` group into each param's buffer: a ``param_gather`` span
    of ``spans``. Returns (params, state, metrics)."""
    from repro_torch.runtime.spans import maybe_span

    device = leaves(params)[0].device
    dims = [_data_dim(s, mesh) for s in leaves(specs)]
    blocks = []
    for g, m, p, s, d in zip(leaves(grads), leaves(state["mu"]), leaves(params),
                             leaves(specs), dims):
        pb = zero1_block(p, s, mesh)
        if tuple(m.shape) != tuple(pb.shape):
            raise ValueError(
                f"moment {tuple(m.shape)} is not this rank's ZeRO-1 block {tuple(pb.shape)} "
                f"of a param {tuple(p.shape)}: build the state with adamw.init(params, "
                "specs=..., mesh=...)")
        blocks.append((zero1_block(g, s, mesh), pb))
    block_grads = unflatten(grads, [g for g, _ in blocks])
    block_params = unflatten(params, [p for _, p in blocks])
    gnorm = global_norm(grads, group=group, split=split)
    _, state, metrics = _apply(cfg, block_grads, state, block_params, gnorm)
    data = mesh.group("data")
    with maybe_span(spans, "param_gather", device):
        for p, (_, pb), d in zip(leaves(params), blocks, dims):
            if d is not None:
                _gather_blocks(p, pb, d, data)
    return params, state, metrics


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


__all__ = ["GatherCounter", "OptConfig", "gather_counter", "global_norm", "init", "schedule",
           "update", "update_zero1", "zero1_block", "zero1_leaf_spec", "zero1_specs"]
