"""Model assembly: layer blocks, stacked layer groups, the encoder, the
cache-free training forward and chunked loss, prefill and decode — the
port of ``repro.models.transformer``.

Layer stacks are compiled into (pattern, repeat) groups
(``ModelConfig.layer_groups``) and each group's params are stacked along
a leading ``repeat`` dim, exactly the JAX package's layout, so carrying
weights across is a plain map. Where JAX scans over the stacked dim,
the port runs a Python loop over ``reps``. KV caches mirror the same
(group, position, stacked) structure.

The training forward (:func:`forward_hidden`, :func:`loss_fn`) is
cache-free and autograd-clean; where JAX remats a layer (``remat`` not
``"none"``), the port wraps it in ``torch.utils.checkpoint`` with JAX's
policy (``"dots"`` a selective checkpoint that saves the unbatched
matrix products, ``"full"`` nothing), which changes memory, not
numbers. The flash kernel has no backward (neither
has the Pallas kernel): ``attn_impl="flash"`` under autograd raises.

A MoE layer (``models.moe``) returns its load-balance aux loss, which
:func:`groups_apply` sums and :func:`loss_fn` adds to the loss.

:func:`loss_fn_ranks` is the training forward of ``n`` data-parallel
ranks at once, for expert parallelism inside the train step: rank
``r``'s rows read rank ``r``'s param tree in every op, and each MoE
layer runs once on the stacked ranks, exchanging tokens with
``moe_apply_ep``'s chain all-to-alls (JAX runs the same forward inside
its DP ``shard_map``, every rank at once).

The mixer is GQA, MLA or Mamba-2 (``spec.mixer``), dispatched three
ways at every site as in the JAX package; an MLA layer caches the
compressed ``ckv``/``krope`` leaves instead of ``k``/``v``, a Mamba
layer its conv window ``conv`` and SSM state ``ssm`` (``models.mamba2``;
no per-position axis). A layer with ``ffn="none"`` (mamba2-2.7b) has no
FFN and no ``norm2``; a hybrid (jamba) interleaves Mamba and GQA layers.

A vision-language batch (qwen2-vl: stub frontend) carries precomputed
``embeds`` (B, S, d) and M-RoPE ``positions`` (3, B, S) instead of
``tokens``. The encoder-decoder (whisper) adds learned positions
(``pos_emb``), a bidirectional encoder over precomputed ``enc_frames``
(:func:`encode`, :func:`encoder_config`), cross-attention and GeLU FFNs
in its decoder layers, and an ``enc`` cache leaf (B, T, d) bf16 with no
``reps`` axis, which every decode step attends to.

Tensor parallelism: on a mesh whose ``model`` axis is live
(``parallel.hints.set_mesh`` of a ``ProcessMesh``, as the train step
runs), the training forward of every family is Megatron's: the embedding and the head table split by vocab
rows (a dim that the TP size does not divide stays whole, as
``param_pspecs`` leaves it), GQA and MLA by heads, the SwiGLU by
``d_ff``, the MoE by experts (``models.moe``), Mamba-2 by ``d_inner``
(``models.mamba2``), and the loss is the vocab-parallel cross-entropy
(``parallel.tp``). Each mixer and FFN reads the TP group off the active
mesh. :func:`prefill` and :func:`decode_step` run the same forms on
this rank's rows and its block of the decode cache (:func:`init_cache`;
``parallel.sharding.place_cache``/``gather_cache`` carry a logical
cache in and out), and gather the vocab-split logits, so every rank of
the group returns the whole (B, V). qwen2-vl's M-RoPE runs on each
rank's heads (its ``(3, B, S)`` positions split over ``data`` on axis
1); whisper's encoder, its cross-attention (the replicated encoder
output through ``copy_to_tp``) and its GeLU FFNs split by heads and
columns, its 51,865-row table and ``pos_emb`` whole. Heads the TP size
does not divide run with ``attn_seq_shard`` (``models.attention``: the
query sequence sharded), and :func:`check_tp` refuses them without it.
A one-sequence decode (``long_500k``, under ``hints.replicated_batch``)
runs on every DP rank with the whole batch and the rank's block of the
cache's slots, the attention's softmax combined over ``data``
(``models.attention``'s sequence-parallel decode).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.parallel import hints
from repro_torch.parallel.tp import gather_from_tp, vocab_parallel_ce
from repro_torch.tree import map_tree, map_with_path

from . import attention as attn
from . import mamba2 as mb
from . import moe as moe_mod
from .config import LayerSpec, ModelConfig
from .layers import (
    cast,
    embed,
    embedding_init,
    gelu_mlp,
    gelu_mlp_init,
    normal,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)

Params = dict

# JAX's remat policies by name: "none" saves everything, "full"
# (``nothing_saveable``) recomputes the whole layer, "dots"
# (``checkpoint_dots_with_no_batch_dims``) saves the output of every
# matrix product without batch dims — ``mm``/``addmm``, which a 3-D x
# 2-D ``matmul`` folds into — and recomputes the rest, ``bmm`` included.
REMAT_POLICIES = ("none", "dots", "full")
_UNBATCHED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_unbatched_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _UNBATCHED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_contexts(remat: str, restore):
    """``checkpoint``'s ``context_fn`` for policy ``remat``: the
    recompute runs on the autograd engine's thread for a CUDA device, so
    its context re-enters the forward's mesh and Manual axes
    (``restore``, a ProcessMesh's layers run collectives) around the
    policy's own."""
    def contexts():
        if remat == "dots":
            fwd, rec = create_selective_checkpoint_contexts(_save_unbatched_dots)
        else:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        return fwd, _entered(restore(), rec)
    return contexts


@contextlib.contextmanager
def _entered(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


# ---------------------------------------------------------------------------
# Single layer
# ---------------------------------------------------------------------------


def layer_init(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, device) -> Params:
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if spec.mixer == "gqa":
        p["mixer"] = attn.gqa_init(gen, cfg, device)
    elif spec.mixer == "mla":
        p["mixer"] = attn.mla_init(gen, cfg, device)
    else:  # mamba
        p["mixer"] = mb.mamba2_init(gen, cfg, device)
    if spec.cross_attention:
        p["norm_ca"] = rmsnorm_init(cfg.d_model, device)
        p["cross"] = attn.cross_attn_init(gen, cfg, device)
    if spec.ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.moe_init(gen, cfg, device)
        elif cfg.ffn_activation == "swiglu":
            p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, device)
        else:
            p["ffn"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, device)
    return p


def _ffn(params: Params, spec: LayerSpec, cfg: ModelConfig,
         x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The FFN sub-block: (x + ffn(norm(x)), aux); aux is the MoE
    load-balance loss, None for a dense FFN."""
    if spec.ffn == "none":
        return x, None
    h = rmsnorm(params["norm2"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    if spec.ffn == "moe":
        h, aux = moe_mod.moe_apply(params["ffn"], h, cfg)
        return x + h, aux
    ffn = gelu_mlp if cfg.ffn_activation != "swiglu" else swiglu
    return x + ffn(params["ffn"], h, group=hints.tp_split_group(cfg.d_ff)), None


def _cross(params: Params, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor,
           enc: torch.Tensor | None) -> torch.Tensor:
    """The cross-attention sub-block of a decoder layer of an
    encoder-decoder (x + cross(norm(x), enc)); ``x`` elsewhere."""
    if not spec.cross_attention:
        return x
    if enc is None:
        raise ValueError("a cross-attention layer needs the encoder output")
    h = rmsnorm(params["norm_ca"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    return x + attn.cross_attn_apply(params["cross"], h, enc, cfg)


def _mix(params: Params, spec: LayerSpec, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, causal: bool) -> torch.Tensor:
    """The mixer sub-block, full sequence: x + mixer(norm(x))."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    if spec.mixer == "gqa":
        h = attn.gqa_apply(params["mixer"], h, positions, cfg, causal=causal)
    elif spec.mixer == "mla":
        h = attn.mla_apply(params["mixer"], h, positions, cfg, causal=causal)
    else:  # mamba: causal by construction
        h = mb.mamba2_apply(params["mixer"], h, cfg)
    return x + h


def layer_apply(
    params: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    enc: torch.Tensor | None = None,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence layer, no cache. Returns (x, aux_loss) — aux is 0
    for the dense FFN."""
    x = _cross(params, spec, cfg, _mix(params, spec, cfg, x, positions, causal), enc)
    x, aux = _ffn(params, spec, cfg, x)
    return x, x.new_zeros((), dtype=torch.float32) if aux is None else aux


def layer_apply_ranks(
    rank_params: list[Params],
    spec: LayerSpec,
    cfg: ModelConfig,
    xs: list[torch.Tensor],
    positions: torch.Tensor,
    *,
    causal: bool = True,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """:func:`layer_apply` for ``n`` ranks at once: rank ``r``'s rows
    ``xs[r]`` through tree ``rank_params[r]``, except that a MoE FFN
    runs once on all ranks' tokens (``moe.moe_apply`` with the per-rank
    trees; ``cfg.moe_ep_dispatch`` and the mesh named by
    ``parallel.hints.set_mesh`` make it ``moe_apply_ep``). Returns
    (xs, aux): the MoE aux is the global one, every rank's."""
    xs = [_mix(p, spec, cfg, x, positions, causal) for p, x in zip(rank_params, xs)]
    aux = xs[0].new_zeros((), dtype=torch.float32)
    if spec.ffn == "moe":
        h = torch.cat([rmsnorm(p["norm2"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
                       for p, x in zip(rank_params, xs)])
        out, aux = moe_mod.moe_apply([p["ffn"] for p in rank_params], h, cfg)
        xs = [x + o for x, o in zip(xs, out.chunk(len(xs)))]
    else:
        xs = [_ffn(p, spec, cfg, x)[0] for p, x in zip(rank_params, xs)]
    return xs, aux


def layer_prefill(
    params: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    max_seq: int,
    *,
    enc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """Full-sequence layer that also emits its decode cache."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    if spec.mixer == "gqa":
        h, cache = attn.gqa_prefill(params["mixer"], h, positions, cfg, max_seq)
    elif spec.mixer == "mla":
        h, cache = attn.mla_prefill(params["mixer"], h, positions, cfg, max_seq)
    else:
        h, cache = mb.mamba2_prefill(params["mixer"], h, cfg)
    return _ffn(params, spec, cfg, _cross(params, spec, cfg, x + h, enc))[0], cache


def layer_decode(
    params: Params,
    spec: LayerSpec,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,
    cache: Params,
    *,
    enc: torch.Tensor | None = None,
) -> tuple[torch.Tensor, Params]:
    """One-token layer; updates ``cache`` in place (see ``gqa_decode``)."""
    h = rmsnorm(params["norm1"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    if spec.mixer == "gqa":
        h, cache = attn.gqa_decode(params["mixer"], h, pos, cache, cfg)
    elif spec.mixer == "mla":
        h, cache = attn.mla_decode(params["mixer"], h, pos, cache, cfg)
    else:
        h, cache = mb.mamba2_decode(params["mixer"], h, cache, cfg)
    return _ffn(params, spec, cfg, _cross(params, spec, cfg, x + h, enc))[0], cache


def layer_init_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, max_seq: int,
                     device) -> Params:
    if spec.mixer == "gqa":
        return attn.gqa_init_cache(cfg, batch, max_seq, device=device)
    if spec.mixer == "mla":
        return attn.mla_init_cache(cfg, batch, max_seq, device=device)
    return mb.mamba2_init_cache(cfg, batch, device=device)


# ---------------------------------------------------------------------------
# Groups (loops over stacked layers)
# ---------------------------------------------------------------------------


def _stack(trees: list[dict]) -> dict:
    return {
        k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
        else torch.stack([t[k] for t in trees])
        for k in trees[0]
    }


def _index(tree: dict, r: int) -> dict:
    """Layer ``r`` of a stacked tree (views, no copy)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def groups_init(gen: torch.Generator, cfg: ModelConfig, device, groups=None, *,
                place=None, prefix: tuple = ("groups",)) -> list[list[Params]]:
    """Each group's layers from ``gen``, stacked per pattern position.
    ``place(path, x)`` (see :func:`model_init`) is applied to each
    layer's leaf before stacking, with the stacked leaf's path."""
    groups = cfg.layer_groups() if groups is None else groups
    out = []
    for g, (pattern, reps) in enumerate(groups):
        # each layer's leaves are copied into their stacked leaf as they
        # are drawn, so a layer is freed before the next is drawn (a list
        # of the layers, stacked at the end, would hold the state twice)
        stacked: list[Params | None] = [None] * len(pattern)
        for r in range(reps):
            for pi, spec in enumerate(pattern):
                p = layer_init(gen, spec, cfg, device)
                if place is not None:
                    p = map_with_path(lambda path, x: place(prefix + (g, pi) + path, x), p)
                if stacked[pi] is None:
                    stacked[pi] = map_tree(lambda x: x.new_empty((reps,) + tuple(x.shape)), p)
                map_tree(lambda buf, x, r=r: buf[r].copy_(x), stacked[pi], p)
                del p
        out.append(stacked)
    return out


def groups_apply(
    gparams: list[list[Params]],
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    enc: torch.Tensor | None = None,
    causal: bool = True,
    remat: str = "dots",
    groups=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer of every group in order; returns (x, summed aux).
    ``remat != "none"`` checkpoints each pattern application with that
    policy (JAX's remat'd scan body)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; expected {tuple(REMAT_POLICIES)}")
    groups = cfg.layer_groups() if groups is None else groups
    aux_total = x.new_zeros((), dtype=torch.float32)
    restore = hints.snapshot()
    for (pattern, reps), stacked in zip(groups, gparams):
        for r in range(reps):
            layer_params = [_index(p, r) for p in stacked]

            def body(h, layer_params=layer_params, pattern=pattern):
                aux = h.new_zeros((), dtype=torch.float32)
                for spec, p in zip(pattern, layer_params):
                    h, a = layer_apply(p, spec, cfg, h, positions, enc=enc, causal=causal)
                    aux = aux + a
                return h, aux

            if remat != "none" and torch.is_grad_enabled():
                x, aux = checkpoint(body, x, use_reentrant=False,
                                    context_fn=_remat_contexts(remat, restore))
            else:
                x, aux = body(x)
            aux_total = aux_total + aux
    return x, aux_total


def groups_init_cache(cfg: ModelConfig, batch: int, max_seq: int, device,
                      groups=None) -> list[list[Params]]:
    groups = cfg.layer_groups() if groups is None else groups
    return [
        [
            _stack([layer_init_cache(spec, cfg, batch, max_seq, device) for _ in range(reps)])
            for spec in pattern
        ]
        for pattern, reps in groups
    ]


def groups_decode(
    gparams: list[list[Params]],
    caches: list[list[Params]],
    cfg: ModelConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    *,
    enc: torch.Tensor | None = None,
    groups=None,
) -> tuple[torch.Tensor, list[list[Params]]]:
    """Decode through every group; each layer writes its K/V row into
    its slice of the stacked cache in place. Returns ``caches``."""
    groups = cfg.layer_groups() if groups is None else groups
    for (pattern, reps), stacked, cstacked in zip(groups, gparams, caches):
        for r in range(reps):
            for spec, p, c in zip(pattern, stacked, cstacked):
                x, _ = layer_decode(_index(p, r), spec, cfg, x, pos, _index(c, r), enc=enc)
    return x, caches


# ---------------------------------------------------------------------------
# Full model: init / prefill / decode
# ---------------------------------------------------------------------------


def model_init(gen: torch.Generator, cfg: ModelConfig, device="cuda", *,
               place=None) -> Params:
    """Random f32 params from ``gen`` on ``device`` (default ``"cuda"``),
    nested as ``repro.models.transformer.model_init``'s.

    ``place(path, x) -> x`` is applied to each leaf as it is drawn, in
    the draw order of the whole model, so the draws are the same with or
    without it: a layer's leaf before its group is stacked (``path`` is
    the stacked leaf's, ``x`` one layer of it). A tensor-parallel rank
    keeps its block of each leaf this way, never holding the whole
    model."""
    device = resolve_device(device)

    def put(path, x):
        return x if place is None else map_with_path(lambda sub, t: place(path + sub, t), x)

    p: Params = {"embed": put(("embed",), embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                                         device))}
    p["final_norm"] = put(("final_norm",), rmsnorm_init(cfg.d_model, device))
    p["groups"] = groups_init(gen, cfg, device, place=place)
    if not cfg.tie_embeddings:
        p["lm_head"] = put(("lm_head",), embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                                        device))
    if cfg.pos_scheme == "learned":
        p["pos_emb"] = put(("pos_emb",), normal(
            gen, (cfg.max_position_embeddings, cfg.d_model), 0.02, device))
    if cfg.is_encdec:
        enc_cfg = encoder_config(cfg)
        p["encoder"] = {
            "groups": groups_init(gen, enc_cfg, device, enc_cfg.layer_groups(), place=place,
                                  prefix=("encoder", "groups")),
            "final_norm": put(("encoder", "final_norm"), rmsnorm_init(cfg.d_model, device)),
            "pos_emb": put(("encoder", "pos_emb"), normal(
                gen, (cfg.encoder_seq_len, cfg.d_model), 0.02, device)),
        }
    return p


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """Whisper encoder stack: bidirectional GQA + GeLU FFN, no MoE. It
    inherits ``attn_impl``, so ``"flash"`` reaches the flash wrapper,
    which refuses the published 1500 frames (not a multiple of its
    block), as the Pallas kernel's wrapper does."""
    return dataclasses.replace(
        cfg,
        num_layers=cfg.encoder_layers,
        num_experts=0,
        attn_period=0,
        encoder_layers=0,  # the encoder itself is not enc-dec
        pos_scheme="learned",
    )


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "dots") -> torch.Tensor:
    """Whisper encoder over precomputed frame embeddings (B, T, d) (stub
    frontend): bf16 frames plus the encoder's learned positions, its
    layers with no causal mask, then its final RMSNorm."""
    enc_cfg = encoder_config(cfg)
    B, T = frames.shape[:2]
    x = cast(frames) + cast(params["encoder"]["pos_emb"][:T])
    pos = torch.arange(T, dtype=torch.int32, device=frames.device).expand(B, T)
    x, _ = groups_apply(params["encoder"]["groups"], enc_cfg, x, pos, causal=False,
                        remat=remat, groups=enc_cfg.layer_groups())
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    """A zero decode cache of ``batch`` rows and ``max_seq`` positions.
    Under a mesh whose ``model`` axis is live (``hints.set_mesh``), this
    rank's block of it, as :func:`prefill` builds it there: the KV heads
    the rank's attention reads (its block, or all of them where the TP
    size does not divide them), a Mamba-2 layer's heads and conv window
    (``models.mamba2.mamba2_init_cache``); ``batch`` is the rank's rows.
    Inside ``hints.replicated_batch`` on a mesh whose ``data`` axis is
    live (``long_500k``: ``batch`` is the whole, replicated batch), each
    ``k``/``v`` and ``ckv``/``krope`` leaf holds the rank's block of the
    slots, as ``cache_pspecs`` splits them (``models.attention``); the
    Mamba-2 leaves, which have no slot axis, stay whole on every DP
    rank."""
    device = resolve_device(device)
    cache: dict = {"layers": groups_init_cache(cfg, batch, max_seq, device)}
    if cfg.is_encdec:
        cache["enc"] = torch.zeros((batch, cfg.encoder_seq_len, cfg.d_model),
                                   dtype=torch.bfloat16, device=device)
    return cache


def check_tp(cfg: ModelConfig) -> None:
    """Refuse, when the active mesh's ``model`` axis is live, an
    attention that does not run at its TP size
    (``attention.heads_refusal``): heads the TP size does not divide
    without ``attn_seq_shard`` (or in MLA). Every family runs under TP,
    each of the ten architectures at
    TP = 2 (``NotImplementedError`` otherwise, before any collective)."""
    tp = hints.tp_size()
    mixers = {s.mixer for pattern, _ in cfg.layer_groups() for s in pattern}
    if cfg.is_encdec:
        mixers.add("gqa")  # the encoder's and the cross-attention
    for mixer in mixers & {"gqa", "mla"}:
        why = attn.heads_refusal(cfg, tp, mla=mixer == "mla")
        if why:
            raise NotImplementedError(f"{cfg.name}: {why}")


def _head_table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"] if cfg.tie_embeddings else params["lm_head"])["table"]


def _logits(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The whole f32 logits (B, V) of the last hidden rows ``h`` (B, d):
    with a vocab-split head table, each rank's block gathered over the
    TP group, so every rank reads the same row (JAX's prefill out spec
    ``P(batch, None)``)."""
    group = hints.tp_split_group(cfg.vocab_size)
    return gather_from_tp(unembed({"table": _head_table(params, cfg)}, h, group), group, -1)


def _inputs(params: Params, cfg: ModelConfig, batch: dict, remat: str):
    """The decoder's input rows, their positions and the encoder output
    of ``batch``: precomputed ``embeds`` with M-RoPE ``positions``
    (3, B, S), or embedded ``tokens`` at 0..S-1; plus the learned
    positions and ``encode(batch["enc_frames"])`` where the model has
    them."""
    if "embeds" in batch:  # vlm: precomputed patch/token embeddings
        x = cast(batch["embeds"])
        positions = batch["positions"]
    else:
        tokens = batch["tokens"]
        x = embed(params["embed"], tokens, group=hints.tp_split_group(cfg.vocab_size))
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device).expand(tokens.shape)
    S = x.shape[1]
    if cfg.pos_scheme == "learned":
        x = x + cast(params["pos_emb"][:S])
    enc = encode(params, cfg, batch["enc_frames"], remat=remat) if cfg.is_encdec else None
    return x, positions, enc


def forward_hidden(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    *,
    remat: str = "dots",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, d) after the final norm, aux_loss), with
    no cache: the training forward."""
    check_tp(cfg)
    x, positions, enc = _inputs(params, cfg, batch, remat)
    x, aux = groups_apply(params["groups"], cfg, x, positions, enc=enc, remat=remat)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm), aux


def _ce(params: Params, cfg: ModelConfig, hidden: torch.Tensor, labels: torch.Tensor,
        loss_chunks: int, z_loss: float) -> torch.Tensor:
    """Mean next-token CE plus z-loss of ``hidden`` (B, S, d), in
    sequence chunks, with f32 logits against the f32 head table; with a
    vocab-split head table, each rank's block of the logits and the
    vocab-parallel CE."""
    group = hints.tp_split_group(cfg.vocab_size)
    labels = labels.long()
    B, S, _ = hidden.shape
    chunks = loss_chunks
    while S % chunks:
        chunks -= 1
    sc = S // chunks
    table = _head_table(params, cfg).float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(chunks):
        logits = unembed({"table": table}, hidden[:, c * sc : (c + 1) * sc], group)
        ce, zl = vocab_parallel_ce(logits, labels[:, c * sc : (c + 1) * sc], group, z_loss)
        total = total + ce + zl
    return total / (B * S)


def loss_fn(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    *,
    remat: str = "dots",
    loss_chunks: int = 8,
    z_loss: float = 1e-4,
) -> tuple[torch.Tensor, dict]:
    """Next-token CE, in sequence chunks (``loss_chunks``, lowered until
    it divides S), with f32 logits against the f32 head table, plus the
    z-loss ``z_loss * lse**2``. Returns (loss, {"loss", "ce", "aux"});
    on a live TP group the loss is replicated on every rank of it."""
    hidden, aux = forward_hidden(params, cfg, batch, remat=remat)
    ce = _ce(params, cfg, hidden, batch["labels"], loss_chunks, z_loss)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def loss_fn_ranks(
    rank_params: list[Params],
    cfg: ModelConfig,
    batch: dict,
    *,
    remat: str = "dots",
    loss_chunks: int = 8,
    z_loss: float = 1e-4,
) -> tuple[torch.Tensor, dict]:
    """:func:`loss_fn` of ``n = len(rank_params)`` data-parallel ranks
    in one forward: ``batch``'s rows split into ``n`` equal blocks, rank
    ``r``'s block through tree ``rank_params[r]`` (the trees may be one
    object), every MoE layer across the ranks (:func:`layer_apply_ranks`).
    Returns ((n,) per-rank losses, metrics averaged over the ranks) — each
    rank's loss its own mean CE plus the global aux, as under JAX's DP
    ``shard_map``. ``remat != "none"`` checkpoints each pattern
    application of all ranks."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat {remat!r}; expected {tuple(REMAT_POLICIES)}")
    if "embeds" in batch or cfg.is_encdec:
        raise NotImplementedError("the joint expert-parallel forward takes token batches of "
                                  "decoder-only models")
    n = len(rank_params)
    tokens = batch["tokens"]
    if tokens.shape[0] % n:
        raise ValueError(f"batch dim {tokens.shape[0]} not divisible by {n} DP ranks")
    tokens = tokens.reshape((n, -1) + tuple(tokens.shape[1:]))
    labels = batch["labels"].reshape(tokens.shape)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(
        tokens.shape[1], S)
    xs = [embed(p["embed"], t) for p, t in zip(rank_params, tokens)]
    aux = xs[0].new_zeros((), dtype=torch.float32)
    restore = hints.snapshot()
    groups = cfg.layer_groups()
    for g, (pattern, reps) in enumerate(groups):
        for r in range(reps):
            layers = [[_index(p, r) for p in rp["groups"][g]] for rp in rank_params]

            def body(*hs, layers=layers, pattern=pattern):
                hs, a = list(hs), hs[0].new_zeros((), dtype=torch.float32)
                for pi, spec in enumerate(pattern):
                    hs, ai = layer_apply_ranks([lp[pi] for lp in layers], spec, cfg, hs,
                                               positions)
                    a = a + ai
                return (*hs, a)

            if remat != "none" and torch.is_grad_enabled():
                *xs, a = checkpoint(body, *xs, use_reentrant=False,
                                    context_fn=_remat_contexts(remat, restore))
            else:
                *xs, a = body(*xs)
            aux = aux + a
    ce = torch.stack([
        _ce(p, cfg, rmsnorm(p["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm), lab,
            loss_chunks, z_loss)
        for p, x, lab in zip(rank_params, xs, labels)])
    losses = ce + aux
    return losses, {"loss": losses.mean(), "ce": ce.mean(), "aux": aux}


def prefill(
    params: Params,
    cfg: ModelConfig,
    batch: dict,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Process the prompt (``batch["tokens"]`` (B, S), or ``embeds`` and
    ``positions``; plus ``enc_frames`` for an encoder-decoder), build
    the decode cache, return last-token logits (B, V) in f32. On a live
    TP group the batch is this rank's rows, the cache this rank's block
    (:func:`init_cache`) and the logits whole on every rank of the
    group."""
    check_tp(cfg)
    x, positions, enc = _inputs(params, cfg, batch, "none")

    caches: list[list[Params]] = []
    for (pattern, reps), stacked in zip(cfg.layer_groups(), params["groups"]):
        per_pos: list[list[Params]] = [[] for _ in pattern]
        for r in range(reps):
            for pi, (spec, p) in enumerate(zip(pattern, stacked)):
                x, c = layer_prefill(_index(p, r), spec, cfg, x, positions, max_seq, enc=enc)
                per_pos[pi].append(c)
        caches.append([_stack(cs) for cs in per_pos])

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    logits = _logits(params, cfg, x[:, -1])
    cache: dict = {"layers": caches}
    if cfg.is_encdec:
        cache["enc"] = enc.to(torch.bfloat16)
    return logits, cache


def decode_step(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B,) current token ids
    pos: torch.Tensor,  # scalar int32 — or (B,) per-slot absolute positions
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One decode step: returns (logits (B, V), cache).

    With a ``(B,)`` ``pos`` every batch row advances at its own absolute
    position (continuous batching). The cache is updated in place and
    returned; an encoder-decoder attends to its ``enc`` leaf. On a live
    TP group, as :func:`prefill`: this rank's rows and cache block, the
    whole logits."""
    check_tp(cfg)
    x = embed(params["embed"], tokens[:, None],
              group=hints.tp_split_group(cfg.vocab_size))  # (B, 1, d)
    if cfg.pos_scheme == "learned":
        # index_select: a 0-dim index would be read back to the host
        idx = torch.as_tensor(pos, device=x.device).reshape(-1)
        x = x + cast(params["pos_emb"].index_select(0, idx))[:, None, :]  # (B or 1, 1, d)
    x, _ = groups_decode(params["groups"], cache["layers"], cfg, x, pos, enc=cache.get("enc"))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps, bf16=cfg.bf16_norm)
    return _logits(params, cfg, x[:, 0]), cache


__all__ = [
    "REMAT_POLICIES",
    "check_tp",
    "decode_step",
    "encode",
    "encoder_config",
    "forward_hidden",
    "groups_apply",
    "groups_decode",
    "groups_init",
    "groups_init_cache",
    "init_cache",
    "layer_apply",
    "layer_apply_ranks",
    "layer_decode",
    "layer_init",
    "layer_prefill",
    "loss_fn",
    "loss_fn_ranks",
    "model_init",
    "prefill",
]
