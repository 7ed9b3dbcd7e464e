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
collectives of a TP group (and the flat MoE dispatch's exchange of its
per-expert counts over ``data``), forward and backward apart;
:func:`modeled_tp_bytes` is what a train step of any family should
count, :func:`modeled_tp_serve_bytes` what a prefill or a decode step
should. Inside :func:`timed` each collective is a ``tp_comm`` span.
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


def _seq_attn_bytes(cfg, tokens: int, tp: int, act_bytes: int, *, kv_heads: int,
                    kv_tokens: int = 0, decode: bool = False) -> tuple[int, int]:
    """(forward, backward) payload of an attention with the query
    sequence sharded (``attn_seq_shard``; ``models.attention``): forward,
    the rank's block of each weight that ``param_pspecs`` splits,
    gathered (in the compute dtype), and the all-reduce of the rows'
    output; backward, every weight's grad (split or whole) all-reduced,
    the input's grad and, for a cross-attention, the encoder output's
    (``kv_tokens`` rows). ``decode``: GQA's one-row decode, every rank
    running every head on the gathered weights, with no all-reduce."""
    H, Dh, d = cfg.num_heads, cfg.resolved_head_dim, cfg.d_model
    cols = {"q": H * Dh, "k": kv_heads * Dh, "v": kv_heads * Dh, "o": H * Dh}
    sizes = [(cols[n] * d, cols[n]) for n in "qkvo"]  # (numel, the dim param_pspecs splits)
    if cfg.qkv_bias and not kv_tokens:
        sizes += [(cols[n], cols[n]) for n in "qkv"]
    gathered = sum(n // tp for n, dim in sizes if dim % tp == 0) * act_bytes
    act = tokens * d * act_bytes
    if decode:
        return gathered, 0
    return (gathered + act,
            sum(n for n, _ in sizes) * act_bytes + act + kv_tokens * d * act_bytes)


def _slot_combine_bytes(spec, cfg, rows: int, tp: int) -> int:
    """The f32 payload of one decode step's softmax combine over a slot
    split (``models.attention``: sequence parallelism) in a layer of
    ``spec``: the max and the sum of exponentials, ``(rows, H)`` each,
    and the weighted values, ``(rows, H, Dh)`` (MLA: ``dv``, or the
    compressed ``r`` when absorbed), for the query heads ``H`` the rank
    runs (its block where the TP size divides them, else all)."""
    if spec.mixer == "mla":
        heads = cfg.num_heads // tp
        width = cfg.kv_lora_rank if cfg.mla_absorb else cfg.v_head_dim
    elif spec.mixer == "gqa":
        heads = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
        width = cfg.resolved_head_dim
    else:
        return 0
    return rows * heads * (2 + width) * 4


def _layer_tp_bytes(spec, cfg, tokens: int, tp: int, act_bytes: int, *, enc_tokens: int = 0,
                    dp: int = 1, decode: bool = False,
                    slot_split: int = 1) -> tuple[int, int, int]:
    """(forward, backward, tail) payload bytes of one layer of ``spec``
    on ``tokens`` at TP ``tp``; ``tail`` is the forward's last
    all-reduce where nothing after it in the layer saves a tensor for
    the backward (the recompute of a remat'd body stops before it).
    ``enc_tokens``: the encoder output's rows a cross-attention reads;
    ``dp``: the DP ranks whose per-expert counts a flat MoE dispatch
    exchanges (the global batch's capacity); ``decode``: a one-row
    decode step; ``slot_split``: the ranks over which its cache's slots
    are split (the softmax combine over them)."""
    act = tokens * cfg.d_model * act_bytes
    fwd = bwd = 0
    if decode and slot_split > 1:
        fwd += _slot_combine_bytes(spec, cfg, tokens, tp)
    mixer_out = 0
    seq = tp > 1 and cfg.attn_seq_shard
    if tp == 1:
        pass
    elif spec.mixer == "gqa" and seq and (not decode or cfg.num_heads % tp):
        f, b = _seq_attn_bytes(cfg, tokens, tp, act_bytes, kv_heads=cfg.num_kv_heads,
                               decode=decode)
        fwd, bwd, mixer_out = fwd + f, bwd + b, 0 if decode else act
    elif spec.mixer == "gqa":
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
    if spec.cross_attention and tp > 1:
        if seq:
            f, b = _seq_attn_bytes(cfg, tokens, tp, act_bytes, kv_heads=cfg.num_heads,
                                   kv_tokens=enc_tokens)
        else:  # wo's all-reduce; the grads of the decoder rows and of the encoder output
            f, b = act, act + enc_tokens * cfg.d_model * act_bytes
        fwd, bwd, mixer_out = fwd + f, bwd + b, act
    ffn_out = 0
    if spec.ffn == "dense" and cfg.d_ff % tp == 0 and tp > 1:  # SwiGLU or GeLU
        fwd, bwd, ffn_out = fwd + act, bwd + act, act
    elif spec.ffn == "moe":
        experts = cfg.num_experts % tp == 0
        shared = cfg.num_shared_experts and (cfg.num_shared_experts * cfg.moe_d_ff) % tp == 0
        if tp > 1 and (experts or shared):
            # the f32 combine's all-reduce; the grads of the split
            # branches' input and of the router weights top_p
            ffn_out = tokens * cfg.d_model * 4
            fwd += ffn_out
            bwd += act + experts * tokens * cfg.moe_top_k * 4
        if dp > 1 and not (cfg.moe_row_dispatch or cfg.moe_ep_dispatch):
            # the flat dispatch's (2, E) f32 counts and probability sums,
            # gathered over data; the gathered (dp, 2, E)'s grad summed
            fwd += 2 * cfg.num_experts * 4
            bwd += dp * 2 * cfg.num_experts * 4
    tail = ffn_out if spec.ffn != "none" else mixer_out
    return fwd, bwd, tail


def _stack_tp_bytes(cfg, groups, tokens: int, tp: int, act_bytes: int, remat: bool,
                    **kw) -> tuple[int, int]:
    fwd = bwd = 0
    for pattern, reps in groups:
        layers = [_layer_tp_bytes(spec, cfg, tokens, tp, act_bytes, **kw) for spec in pattern]
        body = sum(f for f, _, _ in layers)
        recompute = body - layers[-1][2] if remat else 0
        fwd += reps * (body + recompute)
        bwd += reps * sum(b for _, b, _ in layers)
    return fwd, bwd


def modeled_tp_bytes(cfg, tokens: int, tp: int, *, remat: bool = True, enc_tokens: int = 0,
                     dp: int = 1, embeds: bool | None = None) -> dict:
    """The payload bytes :data:`tp_counter` counts for one train step of
    ``cfg`` on ``tokens`` (B·S) of this rank, at TP ``tp``. Forward, per
    layer: the mixer's output all-reduce (GQA's and MLA's ``wo``,
    Mamba-2's ``out_proj`` where ``d_inner`` is split), GQA's K/V gather
    (where a rank holds part of a KV head), Mamba-2's gated-norm sum of
    squares (f32, one a token), the cross-attention's ``wo``, the
    SwiGLU's or GeLU's all-reduce (where ``d_ff`` is split) or the MoE's
    f32 combine (where the experts or the shared experts are split); under
    ``attn_seq_shard`` an attention's gathered weight blocks and its
    rows' all-reduce instead (:func:`_seq_attn_bytes`); with ``dp`` > 1
    (the xla step's global batch), a flat MoE dispatch's (2, E) f32
    exchange over ``data``; with ``remat``, each remat'd body (one
    pattern application) once more, but for its last layer's final
    all-reduce: ``torch.utils.checkpoint`` stops the recompute at the
    last tensor the backward saved, before it; an encoder-decoder's
    encoder layers on ``enc_tokens`` (B·T) rows the same way; the
    embedding's all-reduce (not for precomputed embeddings: ``embeds``,
    by default a vlm's batch) and the CE's three per-token f32
    reductions (max, sum of exponentials, gold) where the vocab is
    split, and the
    optimizer's one f32 norm. Backward, per layer: the grads of the
    column-parallel inputs (attention's, MLA's ``wq``, Mamba-2's
    ``in_z``/``in_x``, the FFN's, the MoE's split branches), of the
    replicated tensors where the split use begins (MLA's ``c``/``k_rope``,
    Mamba-2's B/C, dt, ``A_log`` and ``D``, the MoE's ``top_p``, the
    encoder output of each cross-attention), of the gathered K/V, of the
    norm's sum of squares, of a sequence-sharded attention's weights and
    of the MoE exchange; the f32 hidden's grad of the split head.
    Activations are in the compute dtype
    (``models.layers.COMPUTE_DTYPE``)."""
    from repro_torch.models.layers import COMPUTE_DTYPE

    act_bytes = COMPUTE_DTYPE.itemsize
    act = tokens * cfg.d_model * act_bytes
    vocab = tp > 1 and cfg.vocab_size % tp == 0
    fwd, bwd = _stack_tp_bytes(cfg, cfg.layer_groups(), tokens, tp, act_bytes, remat,
                               enc_tokens=enc_tokens, dp=dp)
    if cfg.is_encdec:
        f, b = _stack_tp_bytes(cfg, _encoder_groups(cfg), enc_tokens, tp, act_bytes, remat)
        fwd, bwd = fwd + f, bwd + b
    if embeds is None:  # precomputed embeddings: no table lookup
        embeds = cfg.family == "vlm"
    fwd += vocab * ((not embeds) * act + 3 * tokens * 4) + 4 * (tp > 1)
    bwd += vocab * tokens * cfg.d_model * 4
    return {"fwd": fwd, "bwd": bwd}


def _encoder_groups(cfg):
    from repro_torch.models.transformer import encoder_config

    return encoder_config(cfg).layer_groups()


def modeled_tp_serve_bytes(cfg, batch: int, seq: int, tp: int, *, dp: int = 1,
                           slot_split: int = 1) -> dict:
    """The payload bytes :data:`tp_counter` counts for one prefill of
    ``batch`` rows of ``seq`` tokens on this rank (``seq=1``: one decode
    step of ``batch`` rows) of ``cfg`` at TP ``tp``: the forward alone,
    with no remat and no CE. Per layer, what :func:`modeled_tp_bytes`
    counts forward: the mixer's output all-reduce, GQA's K/V gather
    where a rank holds every KV head (in a decode step, of the new
    row), Mamba-2's sum of squares, the cross-attention's all-reduce,
    the FFN's all-reduce or the MoE's f32 combine, a sequence-sharded
    attention's gathered weights (in a decode step whose heads the TP
    size does not divide, those alone) and, with ``dp`` > 1, a flat MoE
    dispatch's exchange over ``data``; a prefill of an encoder-decoder
    its encoder layers on ``batch × encoder_seq_len`` rows; then, where
    the vocab is split, the embedding's all-reduce (not for a vlm
    prompt's precomputed embeddings) and the gather of the
    f32 last-token logits (each rank sends its ``batch × V/tp``
    block). With ``slot_split`` > 1 (a decode step whose cache's slots
    are split over that many ``data`` ranks: ``long_500k``), each
    attention layer's softmax combine too: two ``(batch, H)`` f32
    reductions and one of the weighted values, ``(batch, H, Dh)`` f32
    (:func:`_slot_combine_bytes`); its batch is replicated, so ``dp``
    stays 1 there."""
    from repro_torch.models.layers import COMPUTE_DTYPE

    act_bytes = COMPUTE_DTYPE.itemsize
    tokens = batch * seq
    enc_tokens = batch * cfg.encoder_seq_len if cfg.is_encdec else 0
    kw = dict(enc_tokens=enc_tokens, dp=dp, decode=seq == 1, slot_split=slot_split)
    fwd = sum(reps * sum(_layer_tp_bytes(spec, cfg, tokens, tp, act_bytes, **kw)[0]
                         for spec in pattern)
              for pattern, reps in cfg.layer_groups())
    if cfg.is_encdec and seq > 1:
        fwd += sum(reps * sum(_layer_tp_bytes(spec, cfg, enc_tokens, tp, act_bytes)[0]
                              for spec in pattern)
                   for pattern, reps in _encoder_groups(cfg))
    if tp > 1 and cfg.vocab_size % tp == 0:
        embeds = cfg.family == "vlm" and seq > 1  # a vlm prompt comes as embeddings
        fwd += (not embeds) * tokens * cfg.d_model * act_bytes
        fwd += batch * (cfg.vocab_size // tp) * 4
    return {"fwd": fwd, "bwd": 0}


def modeled_ep_bytes(cfg, tokens: int, dp: int, rank: int, *, train: bool = False,
                     remat: bool = True) -> int:
    """The bytes this process puts on the wire
    (``core.chainwrite_dist.wire_counter``) in the expert-parallel
    exchanges of ``cfg``'s MoE layers (``moe_apply_ep``'s process form)
    on ``tokens`` of its own, over ``dp`` DP ranks, as group rank
    ``rank``: per layer, three chain all-to-alls of ``cfg.moe_ep_chains``
    rings (one where they do not divide ``dp``) — the tokens
    ``(dp, C_pair, d)`` in the compute dtype (int8 frames under
    ``moe_ep_int8_wire``), their expert ids ``(dp, C_pair)`` int32, the
    results back. ``train``: a train step, whose backward runs the
    transposed exchange of each exact token exchange and whose remat'd
    recompute (``remat``) runs the forward's again. Under a live
    ``model`` axis every model column runs the same exchanges over its
    own DP group, so a rank's count does not depend on the TP size."""
    from repro_torch.core import program as prg
    from repro_torch.core.chainwrite_dist import sent_wire_bytes
    from repro_torch.models.layers import COMPUTE_DTYPE
    from repro_torch.models.moe import _bucket_capacity
    from repro_torch.parallel.collectives import _axis_orders

    moe_layers = sum(reps * sum(s.ffn == "moe" for s in pattern)
                     for pattern, reps in cfg.layer_groups())
    if not moe_layers or dp == 1:
        return 0
    K = cfg.moe_ep_chains if cfg.moe_ep_chains > 1 and dp % cfg.moe_ep_chains == 0 else 1
    orders = tuple(_axis_orders(dp, K, "tsp"))
    wire = "int8" if cfg.moe_ep_int8_wire else None
    C = _bucket_capacity(tokens * cfg.moe_top_k, dp, cfg.capacity_factor)
    act = COMPUTE_DTYPE.itemsize

    def a2a(elems: int, elem_bytes: int, wire_dtype=None) -> int:
        prog = prg.plan_all_to_all(dp, orders, wire_dtype=wire_dtype)
        return sent_wire_bytes(prog, elems * (4 if wire_dtype else elem_bytes), 1, rank)

    tok = a2a(dp * C * cfg.d_model, act, wire)
    ids = a2a(dp * C, 4)
    fwd = 2 * tok + ids
    if not train:
        return moe_layers * fwd
    bwd = 0 if wire else 2 * tok
    return moe_layers * (fwd * (2 if remat else 1) + bwd)


__all__ = ["TPCounter", "all_gather", "all_reduce", "copy_to_tp", "gather_from_tp",
           "modeled_ep_bytes", "modeled_tp_bytes", "modeled_tp_serve_bytes", "reduce_from_tp",
           "sum_over_tp", "timed", "tp_counter", "vocab_parallel_ce"]
