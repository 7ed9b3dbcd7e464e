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
* :func:`sum_over_tp` — all-reduce forward and backward
  (``copy_to_tp ∘ reduce_from_tp``): a statistic that every rank sums
  over its shard and then feeds its own shard again (Mamba-2's gated
  norm's sum of squares over the whole ``d_inner``): each rank's grad of
  the sum holds only its shard's share;
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
:func:`modeled_tp_bytes` is what a train step of the dense, MoE, MLA,
Mamba-2 or hybrid family should count, :func:`modeled_tp_serve_bytes`
what a prefill or a decode step should. Inside :func:`timed` each collective is a ``tp_comm`` span.
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


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group, "fwd")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "bwd"), None


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


def sum_over_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``; backward, the grad
    summed over ``group`` too. For a sum every rank then uses on its own
    shard only, so that its grad on each rank is that shard's share."""
    return x if group is None else _SumOverTP.apply(x, group)


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


def _layer_tp_bytes(spec, cfg, tokens: int, tp: int, act_bytes: int) -> tuple[int, int, int]:
    """(forward, backward, tail) payload bytes of one layer of ``spec``
    on ``tokens`` at TP ``tp``; ``tail`` is the forward's last
    all-reduce where nothing after it in the layer saves a tensor for
    the backward (the recompute of a remat'd body stops before it)."""
    act = tokens * cfg.d_model * act_bytes
    fwd = bwd = 0
    mixer_out = 0
    if spec.mixer == "gqa":
        kv_cols = cfg.num_kv_heads * cfg.resolved_head_dim
        gather = cfg.num_kv_heads % tp != 0
        # wo's all-reduce, the K/V gather; the input's grad, the gathered K/V's
        fwd += act + gather * 2 * tokens * (kv_cols // tp) * act_bytes
        bwd += act + gather * 2 * tokens * kv_cols * act_bytes
        mixer_out = act
    elif spec.mixer == "mla":
        # wo's all-reduce; the grads of wq's input and of c/k_rope
        fwd += act
        bwd += act + tokens * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * act_bytes
        mixer_out = act
    elif cfg.d_inner % tp == 0:  # mamba, split by d_inner
        H, GN = cfg.ssm_nheads, cfg.ssm_ngroups * cfg.ssm_state
        # out_proj's all-reduce and the norm's f32 sum of squares; the
        # grads of in_z/in_x's input, of B/C and dt (f32, replicated), of
        # A_log and D, and of the sum of squares
        fwd += act + tokens * 4
        bwd += act + tokens * (2 * GN + H) * 4 + 2 * H * 4 + tokens * 4
        mixer_out = act
    ffn_out = 0
    if spec.ffn == "dense" and cfg.ffn_activation == "swiglu" and cfg.d_ff % tp == 0:
        fwd, bwd, ffn_out = fwd + act, bwd + act, act
    elif spec.ffn == "moe":
        experts = cfg.num_experts % tp == 0
        shared = cfg.num_shared_experts and (cfg.num_shared_experts * cfg.moe_d_ff) % tp == 0
        if experts or shared:
            # the f32 combine's all-reduce; the grads of the split
            # branches' input and of the router weights top_p
            ffn_out = tokens * cfg.d_model * 4
            fwd += ffn_out
            bwd += act + experts * tokens * cfg.moe_top_k * 4
    tail = ffn_out if spec.ffn != "none" else mixer_out
    return fwd, bwd, tail


def modeled_tp_bytes(cfg, tokens: int, tp: int, *, remat: bool = True) -> dict:
    """The payload bytes :data:`tp_counter` counts for one train step of
    ``cfg`` (the dense, MoE, MLA, Mamba-2 or hybrid family) on
    ``tokens`` (B·S) of this rank, at TP ``tp``. Forward, per layer:
    the mixer's output all-reduce (GQA's and MLA's ``wo``, Mamba-2's
    ``out_proj`` where ``d_inner`` is split), GQA's K/V gather (where a
    rank holds part of a KV head), Mamba-2's gated-norm sum of squares
    (f32, one a token), the SwiGLU's all-reduce (where ``d_ff`` is
    split) or the MoE's f32 combine (where the experts or the shared
    experts are split); with ``remat``, each remat'd body (one pattern
    application) once more, but for its last layer's final all-reduce:
    ``torch.utils.checkpoint`` stops the recompute at the last tensor
    the backward saved, before it; the embedding's all-reduce and the
    CE's three per-token f32 reductions (max, sum of exponentials, gold)
    where the vocab is split, and the optimizer's one f32 norm.
    Backward, per layer: the grads of the column-parallel inputs
    (attention's, MLA's ``wq``, Mamba-2's ``in_z``/``in_x``, the
    SwiGLU's, the MoE's split branches), of the replicated tensors where
    the split use begins (MLA's ``c``/``k_rope``, Mamba-2's B/C, dt,
    ``A_log`` and ``D``, the MoE's ``top_p``), of the gathered K/V and
    of the norm's sum of squares; the f32 hidden's grad of the split
    head. Activations are in the compute dtype
    (``models.layers.COMPUTE_DTYPE``)."""
    from repro_torch.models.layers import COMPUTE_DTYPE

    act_bytes = COMPUTE_DTYPE.itemsize
    act = tokens * cfg.d_model * act_bytes
    vocab = cfg.vocab_size % tp == 0
    fwd, bwd = 0, 0
    for pattern, reps in cfg.layer_groups():
        layers = [_layer_tp_bytes(spec, cfg, tokens, tp, act_bytes) for spec in pattern]
        body = sum(f for f, _, _ in layers)
        recompute = body - layers[-1][2] if remat else 0
        fwd += reps * (body + recompute)
        bwd += reps * sum(b for _, b, _ in layers)
    fwd += vocab * (act + 3 * tokens * 4) + 4
    bwd += vocab * tokens * cfg.d_model * 4
    return {"fwd": fwd, "bwd": bwd}


def modeled_tp_serve_bytes(cfg, batch: int, seq: int, tp: int) -> dict:
    """The payload bytes :data:`tp_counter` counts for one prefill of
    ``batch`` rows of ``seq`` tokens on this rank (``seq=1``: one decode
    step of ``batch`` rows) of ``cfg`` at TP ``tp``: the forward alone,
    with no remat and no CE. Per layer, what :func:`modeled_tp_bytes`
    counts forward: the mixer's output all-reduce, GQA's K/V gather
    where a rank holds every KV head (in a decode step, of the new
    row), Mamba-2's gated-norm sum of squares, the SwiGLU's all-reduce
    or the MoE's f32 combine; then, where the vocab is split, the
    embedding's all-reduce and the gather of the f32 last-token logits
    (each rank sends its ``batch × V/tp`` block)."""
    from repro_torch.models.layers import COMPUTE_DTYPE

    act_bytes = COMPUTE_DTYPE.itemsize
    tokens = batch * seq
    fwd = sum(reps * sum(_layer_tp_bytes(spec, cfg, tokens, tp, act_bytes)[0]
                         for spec in pattern)
              for pattern, reps in cfg.layer_groups())
    if cfg.vocab_size % tp == 0:
        fwd += tokens * cfg.d_model * act_bytes + batch * (cfg.vocab_size // tp) * 4
    return {"fwd": fwd, "bwd": 0}


__all__ = ["TPCounter", "all_gather", "all_reduce", "copy_to_tp", "gather_from_tp",
           "modeled_tp_bytes", "modeled_tp_serve_bytes", "reduce_from_tp", "sum_over_tp",
           "timed", "tp_counter", "vocab_parallel_ce"]
