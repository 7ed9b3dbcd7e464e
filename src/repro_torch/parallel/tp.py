"""Megatron-style tensor parallelism over the ``model`` axis of a
:class:`~repro_torch.launch.mesh.ProcessMesh`: the conjugate pair of
autograd functions, the all-gather whose backward is a reduce-scatter,
and the vocab-parallel cross-entropy.

JAX has no counterpart module. There the model code only hints layouts
(``maybe_shard``) and GSPMD inserts these collectives where a sharded
matmul needs them. Here the model code calls them on the group that
``parallel.hints.tp_group`` reads off the active mesh:

* :func:`copy_to_tp` — identity forward, all-reduce of the grad
  backward: the replicated input of a column-parallel matmul (every
  rank's grad holds only its columns' share);
* :func:`reduce_from_tp` — all-reduce forward, identity backward: the
  partial sums of a row-parallel matmul (the loss is replicated, so
  every rank already holds the whole grad of the sum);
* :func:`gather_from_tp` — all-gather along a dim forward; backward the
  sum of every rank's grad of the gathered tensor, of which this rank
  keeps its own block (a reduce-scatter): where the ranks use different
  parts of the gathered tensor (K/V heads at ``num_kv_heads % tp != 0``)
  a shard's grad comes from other ranks too;
* :func:`vocab_parallel_ce` — the cross-entropy and z-loss of logits
  whose vocab dim is split over the group: the log-sum-exp from a
  max and a sum of exponentials reduced over the group, the gold logit
  masked to the rank that holds it and summed.

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces the grad again, which scales the grads of a loss replicated
on every TP rank by the group size. Each function here is the identity
(or the plain computation) when its group is ``None``. A CUDA tensor on
a gloo group travels through the host, as in ``core.chainwrite_dist``.

:data:`tp_counter` counts the payload bytes this process hands to the
collectives of a TP group, forward and backward apart;
:func:`modeled_tp_bytes` is what a dense model's train step should
count. Inside :func:`timed` each collective is a ``tp_comm`` span.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.runtime.spans import maybe_span


@dataclasses.dataclass
class TPCounter:
    """Payload bytes this process handed to TP collectives: the tensor
    each all-reduce sums, or the shard each all-gather sends, by pass
    (``"fwd"``, ``"bwd"``)."""

    bytes: dict = dataclasses.field(default_factory=lambda: {"fwd": 0, "bwd": 0})

    def reset(self) -> None:
        self.bytes = {"fwd": 0, "bwd": 0}

    def add(self, x: torch.Tensor, phase: str) -> None:
        self.bytes[phase] += x.numel() * x.element_size()


tp_counter = TPCounter()

# the Spans that time each collective as "tp_comm" (:func:`timed`); a
# module global, not a context variable, since a CUDA backward runs its
# collectives on the autograd engine's thread
_SPANS = None


@contextlib.contextmanager
def timed(spans):
    """Inside the block every TP collective of this process is a
    ``tp_comm`` span of ``spans`` (a ``runtime.spans.Spans``; ``None``:
    untimed)."""
    global _SPANS
    old, _SPANS = _SPANS, spans
    try:
        yield
    finally:
        _SPANS = old


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and str(dist.get_backend(group)) == "gloo"


def all_reduce(x: torch.Tensor, group, phase: str = "fwd",
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` of every rank's ``x`` over ``group``."""
    tp_counter.add(x, phase)
    with maybe_span(_SPANS, "tp_comm", x.device):
        if _staged(x, group):
            host = x.cpu()
            dist.all_reduce(host, op=op, group=group)
            return host.to(x.device)
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        return out


def all_gather(x: torch.Tensor, group, dim: int, phase: str = "fwd") -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group rank order."""
    tp_counter.add(x, phase)
    with maybe_span(_SPANS, "tp_comm", x.device):
        src = x.contiguous().cpu() if _staged(x, group) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim).to(x.device)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "bwd"), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, "fwd")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim, "fwd")

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.group, "bwd")
        mine = total.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.n, ctx.n)
        return mine.contiguous(), None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the grad all-reduced over ``group`` backward."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; identity backward."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (group rank order);
    backward, this rank's block of the grads summed over ``group``."""
    if group is None:
        return x
    return _GatherFromTP.apply(x, group, dim % x.dim())


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, group,
                      z_loss: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum of (lse - gold), z_loss * sum of lse**2)`` over the rows of
    f32 ``logits`` (..., V_local), this rank's block of the vocab (group
    rank ``r`` holds ids ``[r·V_local, (r+1)·V_local)``), against
    ``labels`` (...). With ``group=None`` the block is the whole vocab.
    Both sums are replicated on every rank of ``group``; each rank's
    logits get their exact grads (softmax minus one-hot, plus the
    z-loss's, on the rank's columns)."""
    labels = labels.long()
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        m = all_reduce(logits.detach().amax(-1), group, op=dist.ReduceOp.MAX)
        sumexp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(-1), group)
        lse = m + torch.log(sumexp)
        local = labels - dist.get_rank(group) * n
        inside = (local >= 0) & (local < n)
        mine = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        gold = reduce_from_tp(torch.where(inside, mine, torch.zeros_like(mine)), group)
    return (lse - gold).sum(), (lse ** 2).sum() * z_loss


def modeled_tp_bytes(cfg, tokens: int, tp: int, *, remat: bool = True) -> dict:
    """The payload bytes :data:`tp_counter` counts for one train step of
    the dense ``cfg`` on ``tokens`` (B·S) of this rank, at TP ``tp``:
    forward, per layer, the attention output's all-reduce, the SwiGLU's
    (where ``d_ff`` is split) and the K/V gather (where a rank holds
    part of a KV head); with ``remat``, the recompute once more, but for
    the SwiGLU's all-reduce: ``torch.utils.checkpoint`` stops a layer's
    recompute at the last tensor its backward saved, the ``down``
    product's input, before that all-reduce; the
    embedding's all-reduce and the CE's three per-token f32 reductions
    (max, sum of exponentials, gold) where the vocab is split, and the
    optimizer's one f32 norm. Backward, per layer, the all-reduce of the
    attention and SwiGLU inputs' grads and of the gathered K/V's grad;
    the f32 hidden's grad of the split head. Activations are in the
    compute dtype (``models.layers.COMPUTE_DTYPE``)."""
    from repro_torch.models.layers import COMPUTE_DTYPE

    act_bytes = COMPUTE_DTYPE.itemsize
    d, kv_cols = cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim
    act = tokens * d * act_bytes
    ffn, vocab = cfg.d_ff % tp == 0, cfg.vocab_size % tp == 0
    gather = cfg.num_kv_heads % tp != 0
    fwd_layer = act + act * ffn + gather * 2 * tokens * (kv_cols // tp) * act_bytes
    bwd_layer = act + act * ffn + gather * 2 * tokens * kv_cols * act_bytes
    L = cfg.num_layers
    recompute = fwd_layer - act * ffn if remat else 0
    fwd = L * (fwd_layer + recompute) + vocab * (act + 3 * tokens * 4) + 4
    bwd = L * bwd_layer + vocab * tokens * d * 4
    return {"fwd": fwd, "bwd": bwd}


__all__ = ["TPCounter", "all_gather", "all_reduce", "copy_to_tp", "gather_from_tp",
           "modeled_tp_bytes", "reduce_from_tp", "timed", "tp_counter", "vocab_parallel_ce"]
