"""Attention mixers: GQA (+RoPE/M-RoPE, SWA ring-buffer caches), MLA
(DeepSeek-V2) and whisper's cross-attention — the port of
``repro.models.attention``.

``gqa_apply``/``gqa_prefill`` handle the full-sequence path (through the
flash kernel when ``cfg.attn_impl == "flash"``) and ``gqa_decode`` the
single-token path with a KV cache. KV caches for SWA archs are ring
buffers of ``window`` slots.

MLA caches only the compressed KV (``kv_lora_rank`` latent values plus
the shared ``qk_rope_head_dim`` rope key per position, in bf16: the
``ckv``/``krope`` leaves) and recovers per-head K/V by up-projection at
use — the paper's P3/D3 multicast workload, whose KV-prefix payload is
``r + dr`` values a position and layer. It attends by einsums in f32, as
JAX does, so no MLA call reaches the flash kernel; ``cfg.mla_absorb``
absorbs the up-projections into the query and output at decode.

Cross-attention (whisper's decoder) attends to the encoder output by
f32 einsums with no mask; decode recomputes its K/V from all encoder
rows every step (there is no cross-KV cache in either package). Under
TP it splits by heads as GQA does, the replicated encoder output
through ``copy_to_tp``, or with ``attn_seq_shard`` by decoder rows.

Tensor parallelism (``gqa_apply`` on a mesh whose ``model`` axis is
live, ``parallel.hints.tp_group``): ``wq``/``wk``/``wv`` (and their
biases) are column-parallel, so a rank computes its block of the query
heads, and ``wo`` is row-parallel, its partial sums reduced over the
group. Where ``num_kv_heads`` does not divide by the TP size but
``num_kv_heads·head_dim`` does, ``param_pspecs`` still splits the K/V
columns, so a rank may hold part of a head: K and V are gathered over
the group and each rank takes the KV heads its query heads read. With
``attn_seq_shard`` (JAX's ``opt-seq`` variant; the layout for a
``num_heads`` the TP size does not divide, which runs only so) the
query sequence is split instead: each rank attends for its block of
the query rows with every head against K/V of the whole sequence, the
causal mask offset by the block's start, on weights gathered whole
(their grads reduce-scattered back to the blocks ``param_pspecs``
gives), and the rows' output projections are summed over the group; a
one-row decode runs every head on every rank. The flash kernel takes
no query offset, so that form runs the chunked or the reference
attention.
``mla_apply`` is split by heads too: ``wq``, ``w_uk`` and ``w_uv`` are
column-parallel (their flattened ``(H, ·)`` columns give whole heads)
and ``wo`` row-parallel; the compression ``w_dkv`` stays replicated,
and ``copy_to_tp`` sits on its output, where the rank's heads begin to
use it, so ``w_dkv`` gets its whole grad on every rank.

Serving runs the same TP forms (prefill, and decode with the cache a
rank holds). A GQA cache holds the rank's block of the KV heads where
``num_kv_heads`` divides by the TP size, else all of them on every rank
(``cache_pspecs`` replicates it there): the prefill caches the gathered
K/V before each query head's KV head is selected, and a decode step
gathers its new row before writing it. The compressed MLA cache
(``ckv``/``krope``) is computed on every TP rank from the replicated
``w_dkv``, as JAX's code computes it on every shard (``cache_pspecs``
gives it no split); it is not multicast between the ranks, whatever
the JAX module's docstring says of a Chainwrite multicast to the
shards.

Sequence-parallel decode (a ``long_500k`` cell: its one row replicated
on every rank, ``parallel.hints.replicated_batch``): ``cache_pspecs``
splits a decode cache's slots over ``data``, so a rank holds block
``r`` of ``slots / n`` slots of each ``k``/``v`` (``ckv``/``krope``)
leaf (:func:`gqa_init_cache`, :func:`mla_init_cache` under
``hints.seq_group``). A decode step writes the new row only on the rank
that owns global slot ``pos % slots``, masks by the global slot ids
(the ring buffer's wrap and the not-yet-written slots as on the whole
cache), and combines the softmax over the group with three small
all-reduces (:func:`_slot_softmax`, :func:`_slot_sum`): the max of the
scores, the sum of their exponentials, and, after each rank has
normalised its block of the weights (and rounded them to the cache's
bf16 where the whole-cache decode does), the sum of the ranks' weighted
values. The rounding then falls on the same normalised weights as on
the whole cache; an unnormalised flash-decoding merge would round other
values. A rank with no valid slot contributes zeros (its scores are
``NEG_INF``, whose exponentials under the global max are 0). Under a
live ``model`` axis too, each rank runs its KV heads against its slot
block: the two splits compose.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.chunked import attention_chunked
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.parallel import hints
from repro_torch.parallel.tp import all_reduce, copy_to_tp, gather_from_tp, reduce_from_tp

from .config import ModelConfig
from .layers import apply_mrope, apply_rope, cast, matmul, normal

NEG_INF = -1e30


def _full_attention(qt, kt, vt, cfg: ModelConfig, *, causal: bool, q_offset: int = 0):
    """Dispatch on cfg.attn_impl: 'reference' (materialized S² scores),
    'chunked' (online-softmax loop over KV chunks), or 'flash' (the CUDA
    kernel; its plain twin on CPU tensors). ``q_offset``: the queries
    are rows ``q_offset ..`` of the keys' sequence (a block of the query
    sequence under ``attn_seq_shard``); the kernel takes none."""
    if cfg.attn_impl == "flash":
        if q_offset:
            raise NotImplementedError("the flash kernel takes no query offset")
        return flash_attention(
            qt.contiguous(), kt.contiguous(), vt.contiguous(),
            causal=causal, window=cfg.sliding_window,
        )
    if cfg.attn_impl == "chunked":
        return attention_chunked(
            qt, kt, vt, causal=causal, window=cfg.sliding_window,
            chunk=cfg.attn_chunk, q_offset=q_offset,
        )
    return attention_ref(qt, kt, vt, causal=causal, window=cfg.sliding_window,
                         q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": normal(gen, (d, H * Dh), d ** -0.5, device),
        "wk": normal(gen, (d, Hkv * Dh), d ** -0.5, device),
        "wv": normal(gen, (d, Hkv * Dh), d ** -0.5, device),
        "wo": normal(gen, (H * Dh, d), (H * Dh) ** -0.5, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=device)
    return p


def _project_qkv(params, x, cfg: ModelConfig, group=None):
    """Q, K, V (B, S, heads, Dh). With a TP ``group`` (``x`` already
    through ``copy_to_tp``), this rank's query heads, and the KV heads
    its cache holds: its own block of them when ``num_kv_heads``
    divides by the group size, else all of them, gathered over the
    group (:func:`_rank_kv_index` then picks the one each query head
    reads)."""
    B, S, _ = x.shape
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim

    def heads(t):
        return t.reshape(B, S, -1, Dh)

    if group is None or Hkv % dist.get_world_size(group) == 0:
        return tuple(heads(_proj(params, x, cfg, n)) for n in "qkv")
    tp = dist.get_world_size(group)
    if (Hkv * Dh) % tp:
        raise NotImplementedError(
            f"num_kv_heads·head_dim = {Hkv * Dh} at TP={tp}: param_pspecs leaves K/V whole, "
            "and TP over whole K/V columns is not ported (no architecture of the repo has "
            "such a K/V width; ROADMAP §3)")
    q = heads(_proj(params, x, cfg, "q"))
    # a block of the K/V columns: gather both in one collective
    kv = torch.stack([_proj(params, x, cfg, n) for n in "kv"])
    k, v = gather_from_tp(kv, group, -1).reshape(2, B, S, Hkv, Dh).unbind(0)
    return q, k, v


def _rank_kv_index(cfg: ModelConfig, group, device):
    """Where a rank holds every KV head (``num_kv_heads`` does not
    divide by the size of the TP ``group``), the index of the KV head
    of each of its query heads; ``None`` where its KV heads are its own
    block (or there is no group)."""
    if group is None:
        return None
    tp, H, Hkv = dist.get_world_size(group), cfg.num_heads, cfg.num_kv_heads
    if Hkv % tp == 0:
        return None
    Hl, r = H // tp, dist.get_rank(group)
    return torch.arange(r * Hl, (r + 1) * Hl, device=device) // (H // Hkv)


def _select_kv(k, v, idx):
    return (k, v) if idx is None else (k.index_select(2, idx), v.index_select(2, idx))


def _proj(params, x, cfg: ModelConfig, name: str):
    """``x @ w{name} (+ b{name})``, flat (B, S, columns)."""
    t = x @ cast(params["w" + name])
    if cfg.qkv_bias:
        t = t + cast(params["b" + name])
    return t


def _rope(t, positions, cfg: ModelConfig):
    if cfg.pos_scheme == "mrope":
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    if cfg.pos_scheme == "rope":
        return apply_rope(t, positions, cfg.rope_theta)
    return t  # 'learned' / 'none': positions handled at the embedding level.


def _rope_qk(q, k, positions, cfg: ModelConfig):
    return _rope(q, positions, cfg), _rope(k, positions, cfg)


def heads_refusal(cfg: ModelConfig, tp: int, mla: bool = False) -> str | None:
    """Why attention of ``cfg`` does not run at TP ``tp`` (``None``
    where it runs): heads the TP size does not divide, without
    ``attn_seq_shard`` (or in MLA, which has no sequence-sharded form);
    ``attn_seq_shard`` with the flash kernel, which takes no query
    offset."""
    if tp == 1:
        return None
    if cfg.attn_seq_shard and cfg.attn_impl == "flash" and not mla:
        return (f"attn_seq_shard with attn_impl='flash' at TP={tp}: the flash kernel takes no "
                "query offset; the sequence-sharded form runs the chunked or the reference "
                "attention (JAX's opt-seq variant sets 'chunked')")
    if cfg.num_heads % tp and (mla or not cfg.attn_seq_shard):
        where = "in GQA, " if mla else ""
        return (f"num_heads={cfg.num_heads} at TP={tp}: heads that the TP size does not "
                f"divide run only {where}with attn_seq_shard (query-sequence sharding, as "
                "JAX's opt-seq variant sets it)")
    return None


def _tp_heads_group(cfg: ModelConfig, mla: bool = False):
    """The active TP group, over which attention is split by heads
    (``None`` without one); what :func:`heads_refusal` names raises."""
    group = hints.tp_group()
    if group is not None:
        why = heads_refusal(cfg, dist.get_world_size(group), mla)
        if why:
            raise NotImplementedError(why)
    return group


def _seq_group(cfg: ModelConfig):
    """The active TP group where attention is sharded over the query
    sequence (``attn_seq_shard``), else ``None``."""
    group = _tp_heads_group(cfg)
    return group if cfg.attn_seq_shard else None


def _whole_weights(params, cfg: ModelConfig, names, group, kv_heads: int | None = None) -> dict:
    """Each of ``names``' weights whole on every rank, in the compute
    dtype: a block that ``param_pspecs`` split is all-gathered (its
    grad, summed over the group, comes back as this rank's block), a
    whole one passes ``copy_to_tp`` (its grad summed over the group).
    For a form in which every rank computes a share of the rows of one
    layer: each rank's grad of a weight is its rows' share. ``kv_heads``:
    the heads of ``wk``/``wv`` (default ``num_kv_heads``)."""
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    Hkv = cfg.num_kv_heads if kv_heads is None else kv_heads
    full = {"q": H * Dh, "k": Hkv * Dh, "v": Hkv * Dh, "o": H * Dh}
    out = {}
    for name in names:
        w = params[name]
        dim = 0 if name == "wo" or name.startswith("b") else 1
        if w.shape[dim] < full[name[1]]:
            out[name] = gather_from_tp(cast(w), group, dim)
        else:
            out[name] = copy_to_tp(cast(w), group)
    return out


def _row_block(S: int, group) -> tuple[int, int]:
    """This rank's block ``[start, stop)`` of ``S`` query rows: blocks of
    ``ceil(S / tp)`` in group rank order, the last ones shorter (or
    empty) where ``tp`` does not divide ``S``."""
    tp, r = dist.get_world_size(group), dist.get_rank(group)
    n = -(-S // tp)
    start = min(S, r * n)
    return start, min(S, start + n)


def _rows_out(y: torch.Tensor, start: int, S: int, group) -> torch.Tensor:
    """A rank's output rows ``y`` (B, stop - start, d) placed in the
    whole sequence and summed over the group: every rank gets every
    rank's rows (identity backward: each rank's rows take their own part
    of the replicated grad)."""
    return reduce_from_tp(F.pad(y, (0, 0, start, S - start - y.shape[1])), group)


def _gqa_seq_shard(params, x, positions, cfg: ModelConfig, group, *, causal: bool):
    """GQA with the query sequence sharded over ``group``
    (``attn_seq_shard``, JAX's layout for heads the TP size does not
    divide): each rank attends for its block of query rows
    (:func:`_row_block`) with every head, against K/V of the whole
    sequence, the causal mask offset by the block's start; the weights
    are whole on every rank (:func:`_whole_weights`), and the rows'
    output projections are summed over the group (:func:`_rows_out`).
    Returns (out, (k, v) of the whole sequence, every KV head)."""
    B, S, _ = x.shape
    Dh = cfg.resolved_head_dim
    names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    w = _whole_weights(params, cfg, names, group)
    x = copy_to_tp(x, group)
    start, stop = _row_block(S, group)

    def proj(t, n):
        t = t @ w["w" + n]
        t = t + w["b" + n] if cfg.qkv_bias else t
        return t.reshape(B, t.shape[1], t.shape[2] // Dh, Dh)

    q = _rope(proj(x[:, start:stop], "q"), positions[..., start:stop], cfg)
    k, v = _rope(proj(x, "k"), positions, cfg), proj(x, "v")
    out = _full_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), cfg,
                          causal=causal, q_offset=start)
    out = out.transpose(1, 2).reshape(B, stop - start, cfg.num_heads * Dh) @ w["wo"]
    return _rows_out(out, start, S, group), (k, v)


def gqa_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S) or (3, B, S) for M-RoPE
    cfg: ModelConfig,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence GQA (training / prefill), no cache; on a live TP
    group, Megatron's column- and row-parallel form, or with
    ``attn_seq_shard`` the query sequence sharded (module docstring)."""
    seq = _seq_group(cfg)
    if seq is not None:
        return _gqa_seq_shard(params, x, positions, cfg, seq, causal=causal)[0]
    group = _tp_heads_group(cfg)
    x = copy_to_tp(x, group)
    q, k, v = _project_qkv(params, x, cfg, group)
    k, v = _select_kv(k, v, _rank_kv_index(cfg, group, x.device))
    q, k = _rope_qk(q, k, positions, cfg)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B,H,S,D)
    out = _full_attention(qt, kt, vt, cfg, causal=causal)
    B, S = x.shape[:2]
    out = out.transpose(1, 2).reshape(B, S, -1)
    return reduce_from_tp(out @ cast(params["wo"]), group)


def gqa_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence attention that also emits the decode KV cache
    (ring-buffer layout for SWA archs); on a live TP group, split by
    heads as :func:`gqa_apply` is, the cache holding the KV heads
    :func:`_project_qkv` gives the rank (all of them, identical on
    every rank, where ``num_kv_heads`` does not divide by the TP
    size)."""
    _refuse_slot_split("gqa_prefill")
    B, S, _ = x.shape
    seq = _seq_group(cfg)
    if seq is not None:
        out, (k, v) = _gqa_seq_shard(params, x, positions, cfg, seq, causal=True)
        Hc = _cache_kv_heads(cfg)  # the rank's block of the KV heads, or all of them
        r = dist.get_rank(seq) if Hc < cfg.num_kv_heads else 0
        k, v = k[:, :, r * Hc:(r + 1) * Hc], v[:, :, r * Hc:(r + 1) * Hc]
    else:
        group = _tp_heads_group(cfg)
        x = copy_to_tp(x, group)
        q, k, v = _project_qkv(params, x, cfg, group)
        q, k = _rope_qk(q, k, positions, cfg)
        ka, va = _select_kv(k, v, _rank_kv_index(cfg, group, x.device))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, ka, va))
        out = _full_attention(qt, kt, vt, cfg, causal=True)
        out = reduce_from_tp(out.transpose(1, 2).reshape(B, S, -1) @ cast(params["wo"]),
                             group)

    slots = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    cache = gqa_init_cache(cfg, B, max_seq, device=x.device)
    keep = torch.arange(max(0, S - slots), S, device=x.device)  # last `slots` tokens
    slot_ids = keep % slots
    cache["k"][:, slot_ids] = k[:, keep].to(torch.bfloat16)
    cache["v"][:, slot_ids] = v[:, keep].to(torch.bfloat16)
    return out, cache


def _cache_kv_heads(cfg: ModelConfig) -> int:
    """The KV heads a decode cache holds: all of them, or this rank's
    block where the active TP group splits them."""
    tp = hints.tp_size()
    Hkv = cfg.num_kv_heads
    return Hkv // tp if hints.tp_group() is not None and Hkv % tp == 0 else Hkv


def _cache_slots(slots: int) -> int:
    """The slots this rank's decode cache holds of ``slots`` logical
    ones: its block of ``slots / n`` where ``hints.seq_group`` splits
    them (``cache_pspecs``: over ``data`` at global batch 1), else all.
    ``cache_pspecs`` splits only a slot count divisible by 16, and a
    count the group does not divide cannot be placed (``ValueError``)."""
    seq = hints.seq_group()
    if seq is None:
        return slots
    n = dist.get_world_size(seq)
    if slots % 16:
        raise NotImplementedError(
            f"a decode cache of {slots} slots under a replicated batch: cache_pspecs splits "
            "only slot counts divisible by 16 over data, and the port's sequence-parallel "
            "decode takes split caches only")
    if slots % n:
        raise ValueError(f"{slots} cache slots do not split over {n} data ranks")
    return slots // n


def _refuse_slot_split(what: str) -> None:
    """Raise where a decode cache's slots are split (``hints.seq_group``)
    for ``what``, which writes a whole cache: the split is a decode
    cell's (``long_500k`` has no prefill cell in either package)."""
    if hints.seq_group() is not None:
        raise NotImplementedError(
            f"{what} under a replicated batch whose decode cache splits its slots over data: "
            "only the decode step runs sequence-parallel")


def _local_slots(local: int) -> tuple[int, int, object]:
    """(the logical slot count, the global id of this rank's first slot,
    the group) for a decode cache of which this rank holds ``local``
    slots (:func:`_cache_slots`)."""
    seq = hints.seq_group()
    if seq is None:
        return local, 0, None
    return local * dist.get_world_size(seq), dist.get_rank(seq) * local, seq


def _write_row(cache: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor, base: int,
               val: torch.Tensor) -> None:
    """``cache[rows, slot] = val`` in place, ``slot`` a global slot id per
    row: on a rank holding slots ``[base, base + local)`` of them, only
    the rows whose slot it holds are written (a read-modify-write
    with no read back to the host)."""
    local = slot - base
    mine = (local >= 0) & (local < cache.shape[1])
    at = local.clamp(0, cache.shape[1] - 1)
    mask = mine.reshape(mine.shape + (1,) * (val.dim() - 1))
    cache[rows, at] = torch.where(mask, val.to(cache.dtype), cache[rows, at])


def _slot_softmax(s: torch.Tensor, seq) -> torch.Tensor:
    """Softmax over the last dim of scores whose slots the ranks of
    ``seq`` hold in blocks: the max and the sum of the exponentials
    all-reduced over it, so each rank gets its block of the whole
    softmax (``exp(s - max) / sum``, JAX's formula). ``torch.softmax``
    without a group."""
    if seq is None:
        return torch.softmax(s, dim=-1)
    m = all_reduce(s.amax(-1, keepdim=True), seq, op=dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    return e / all_reduce(e.sum(-1, keepdim=True), seq)


def _slot_sum(x: torch.Tensor, seq) -> torch.Tensor:
    """The sum of the ranks' partial products with their slot blocks
    (``x`` itself without a group)."""
    return x if seq is None else all_reduce(x, seq)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    """A zero GQA decode cache: ``batch`` rows of ``min(max_seq,
    window)`` slots (a ring buffer under a sliding window) of the KV
    heads the rank reads (:func:`_cache_kv_heads`); under a slot split
    (``hints.seq_group``) this rank's block of the slots
    (:func:`_cache_slots`)."""
    slots = min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq
    shape = (batch, _cache_slots(slots), _cache_kv_heads(cfg), cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
    }


def gqa_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,  # scalar int32 — or (B,) per-slot absolute positions
    cache: dict,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """Single-token decode with (ring-buffer for SWA) KV cache.

    ``pos`` is either a scalar (every row at the same absolute position)
    or a ``(B,)`` vector of per-slot positions (continuous batching).
    With M-RoPE a scalar ``pos`` feeds all three position streams, and a
    per-slot one raises, as JAX's does. The new K/V rows are written
    into ``cache`` in place — the port keeps one cache instead of
    copying it every token — and ``cache`` is returned. On a live TP
    group a rank runs its query heads against the KV heads its cache
    holds (:func:`gqa_prefill`); where that is all of them, the new K/V
    row is gathered before it is written, so the ranks' caches stay
    equal, and each query head reads its KV head by
    :func:`_rank_kv_index`. Under a slot split (``hints.seq_group``)
    ``cache`` is this rank's block of the slots, and the softmax is
    combined over the group (module docstring)."""
    B = x.shape[0]
    Dh = cfg.resolved_head_dim
    group = _tp_heads_group(cfg)
    if group is not None and cfg.num_heads % dist.get_world_size(group):
        # attn_seq_shard's one query row: every rank runs every head with
        # the weights gathered whole, against its whole cache
        params, group = _whole_weights(params, cfg, tuple(params), group), None
    x = copy_to_tp(x, group)
    q, k, v = _project_qkv(params, x, cfg, group)  # (B,1,*,Dh)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_slot = pos.dim() == 1
    pos_b = pos[:, None] if per_slot else pos.reshape(1, 1).expand(B, 1)
    if cfg.mrope_sections is not None:
        if per_slot:
            raise NotImplementedError("per-slot decode with M-RoPE")
        q, k = _rope_qk(q, k, pos_b.expand(3, B, 1), cfg)
    else:
        q, k = _rope_qk(q, k, pos_b, cfg)

    ck, cv = cache["k"], cache["v"]
    # the logical slots; under a slot split this rank's block starts at base
    slots, base, seq = _local_slots(ck.shape[1])
    rows = torch.arange(B, device=x.device)
    slot_b = (pos_b[:, 0] % slots).long()  # ring-buffer slot per row
    if seq is None:
        ck[rows, slot_b] = k[:, 0].to(ck.dtype)
        cv[rows, slot_b] = v[:, 0].to(cv.dtype)
    else:  # only the rank holding the slot writes it
        _write_row(ck, rows, slot_b, base, k[:, 0])
        _write_row(cv, rows, slot_b, base, v[:, 0])

    ck, cv = _select_kv(ck, cv, _rank_kv_index(cfg, group, x.device))
    H, Hkv = q.shape[2], ck.shape[2]  # this rank's query heads and the KV heads they read
    qh = q[:, 0].reshape(B, Hkv, H // Hkv, Dh)
    # bf16 operands, f32 products and sums (the JAX einsum's
    # preferred_element_type=f32): upcast, since a bf16 einsum would
    # round its result to bf16.
    scores = torch.einsum(
        "bhgd,bshd->bhgs", qh.to(ck.dtype).float(), ck.float()
    ) * (Dh ** -0.5)
    # Valid slots: written positions only (a ring buffer is fully valid
    # once wrapped; before wrapping, slots > pos are empty), by global id.
    slot_ids = base + torch.arange(ck.shape[1], device=x.device)
    valid = (pos_b >= slots) | (slot_ids[None, :] <= pos_b)  # (B, local slots)
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    p = _slot_softmax(scores, seq)
    out = _slot_sum(torch.einsum("bhgs,bshd->bhgd", p.to(cv.dtype).float(), cv.float()), seq)
    out = out.reshape(B, 1, H * Dh).to(x.dtype)
    return reduce_from_tp(out @ cast(params["wo"]), group), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": normal(gen, (d, H * (dn + dr)), d ** -0.5, device),
        "w_dkv": normal(gen, (d, r + dr), d ** -0.5, device),  # compress (+ shared rope key)
        "w_uk": normal(gen, (r, H * dn), r ** -0.5, device),  # K recovery
        "w_uv": normal(gen, (r, H * dv), r ** -0.5, device),  # V recovery
        "wo": normal(gen, (H * dv, d), (H * dv) ** -0.5, device),
    }


def _mla_heads(params, cfg: ModelConfig) -> int:
    """The query heads ``params`` holds: all of them, or this rank's
    block where ``wq`` is split over a TP group (whole heads, since the
    columns are laid out ``(H, dn + dr)``)."""
    return params["wq"].shape[1] // (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_qkv(params, x, positions, cfg: ModelConfig, group=None):
    """(q_nope, q_rope, c, k_rope). With a TP ``group``, this rank's
    query heads (``x`` through ``copy_to_tp`` for ``wq``) and the
    replicated compressed KV, through ``copy_to_tp`` before its split
    use by the rank's heads."""
    B, S, _ = x.shape
    H, r = _mla_heads(params, cfg), cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (copy_to_tp(x, group) @ cast(params["wq"])).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = copy_to_tp(x @ cast(params["w_dkv"]), group)  # (B, S, r + dr)
    c, k_rope = ckv[..., :r], ckv[..., r:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c, k_rope


def _mla_out(params, out: torch.Tensor, like: torch.Tensor, cfg: ModelConfig, group=None):
    """(B, S, H, dv) f32 heads -> the output projection, in ``like``'s
    dtype; with a TP ``group``, row-parallel: the partial sums of this
    rank's heads reduced over it."""
    B, S = out.shape[:2]
    out = out.reshape(B, S, -1).to(like.dtype) @ cast(params["wo"])
    return reduce_from_tp(out, group)


def _mla_attend(params, q_nope, q_rope, c, k_rope, cfg: ModelConfig, mask, group=None, *,
                seq=None):
    """Attention over recovered K/V. c: (B,T,r); k_rope: (B,T,dr);
    q_*: (B,S,H,*). mask: (S,T) or per-row (B,S,T) boolean, or None
    (full). With a TP ``group``, ``H`` is this rank's heads, recovered
    by its columns of ``w_uk``/``w_uv``, and the output is reduced. With
    a slot group ``seq`` (a decode step), ``c``/``k_rope`` are this
    rank's block of the positions: the softmax and the weighted sum of
    the values are combined over ``seq``."""
    if cfg.attn_impl == "chunked" and mask is not None and mask.dim() == 2:
        return _mla_attend_chunked(params, q_nope, q_rope, c, k_rope, cfg, group)
    B, T = c.shape[:2]
    H = _mla_heads(params, cfg)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    # KV recovery (the paper's P3/D3 multicast workload under TP)
    # c may be the bf16 cache under an f32 compute dtype: JAX's promotion
    k_nope = matmul(c, params["w_uk"]).reshape(B, T, H, dn)
    v = matmul(c, params["w_uv"]).reshape(B, T, H, dv)
    s = (
        torch.einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
        + torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())
    ) * (dn + dr) ** -0.5
    if mask is not None:
        m = mask[:, None] if mask.dim() == 3 else mask[None, None]
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = _slot_softmax(s, seq)
    out = _slot_sum(torch.einsum("bhst,bthd->bshd", p, v.float()), seq)
    return _mla_out(params, out, q_nope, cfg, group)


def _mla_attend_chunked(params, q_nope, q_rope, c, k_rope, cfg: ModelConfig, group=None):
    """Causal MLA attention, online softmax over T chunks: recovery
    happens per KV chunk inside the loop (JAX's ``lax.scan``), so nothing
    quadratic or proportional to T·H·dn is made. Assumes S == T with a
    causal mask (training / prefill)."""
    B, T = c.shape[:2]
    S = q_nope.shape[1]
    assert S == T, (S, T)
    H = _mla_heads(params, cfg)
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = (dn + dr) ** -0.5
    C = min(cfg.attn_chunk, T)
    pad = (-T) % C
    if pad:
        c = F.pad(c, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    rows = torch.arange(S, device=c.device)[:, None]
    qn = q_nope.float() * scale  # (B,S,H,dn)
    qr = q_rope.float() * scale  # (B,S,H,dr)
    m = torch.full((B, H, S, 1), NEG_INF, dtype=torch.float32, device=c.device)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=c.device)
    acc = torch.zeros((B, H, S, dv), dtype=torch.float32, device=c.device)
    for start in range(0, T + pad, C):
        cb, krb = c[:, start : start + C], k_rope[:, start : start + C]
        k_nope = (cb @ cast(params["w_uk"])).reshape(B, C, H, dn)
        vb = (cb @ cast(params["w_uv"])).reshape(B, C, H, dv)
        s = (torch.einsum("bshd,bthd->bhst", qn, k_nope.float())
             + torch.einsum("bshd,btd->bhst", qr, krb.float()))  # (B,H,S,C)
        cols = start + torch.arange(C, device=c.device)[None, :]
        s = torch.where(((cols < T) & (cols <= rows))[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhst,bthd->bhsd", p, vb.float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return _mla_out(params, (acc / l).transpose(1, 2), q_nope, cfg, group)


def mla_apply(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence MLA (training / prefill), no cache; on a live TP
    group, split by heads (module docstring)."""
    group = _tp_heads_group(cfg, mla=True)
    S = x.shape[1]
    q_nope, q_rope, c, k_rope = _mla_qkv(params, x, positions, cfg, group)
    mask = _causal_mask(S, x.device) if causal else None
    return _mla_attend(params, q_nope, q_rope, c, k_rope, cfg, mask, group)


def _causal_mask(S: int, device) -> torch.Tensor:
    return torch.ones((S, S), dtype=torch.bool, device=device).tril()


def mla_prefill(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    max_seq: int,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence MLA that also emits the compressed decode cache;
    on a live TP group split by heads (:func:`mla_apply`), the cache
    whole and equal on every rank."""
    _refuse_slot_split("mla_prefill")
    B, S, _ = x.shape
    group = _tp_heads_group(cfg, mla=True)
    q_nope, q_rope, c, k_rope = _mla_qkv(params, x, positions, cfg, group)
    out = _mla_attend(params, q_nope, q_rope, c, k_rope, cfg, _causal_mask(S, x.device), group)
    cache = mla_init_cache(cfg, B, max_seq, device=x.device)
    cache["ckv"][:, :S] = c.to(torch.bfloat16)
    cache["krope"][:, :S] = k_rope.to(torch.bfloat16)
    return out, cache


def mla_init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, device) -> dict:
    """A zero compressed decode cache of ``batch`` rows and ``max_seq``
    positions; under a slot split this rank's block of the positions
    (:func:`_cache_slots`)."""
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    T = _cache_slots(max_seq)
    return {
        "ckv": torch.zeros((batch, T, r), dtype=torch.bfloat16, device=device),
        "krope": torch.zeros((batch, T, dr), dtype=torch.bfloat16, device=device),
    }


def mla_decode(
    params: dict,
    x: torch.Tensor,  # (B, 1, d)
    pos: torch.Tensor,  # scalar int32 — or (B,) per-slot absolute positions
    cache: dict,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """Single-token MLA decode against the compressed cache, written in
    place and returned (as :func:`gqa_decode`); ``cfg.mla_absorb``
    takes :func:`_mla_decode_absorbed`. On a live TP group both forms
    run this rank's heads against the whole compressed cache; under a
    slot split (``hints.seq_group``) against this rank's block of its
    positions, the softmax combined over the group (module
    docstring)."""
    B = x.shape[0]
    group = _tp_heads_group(cfg, mla=True)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    per_slot = pos.dim() == 1
    pos_b = pos[:, None] if per_slot else pos.reshape(1, 1).expand(B, 1)
    q_nope, q_rope, c, k_rope = _mla_qkv(params, x, pos_b, cfg, group)
    ckv, krope = cache["ckv"], cache["krope"]
    _, base, seq = _local_slots(ckv.shape[1])
    rows, at = torch.arange(B, device=x.device), pos_b[:, 0].long()
    if seq is None:
        ckv[rows, at] = c[:, 0].to(ckv.dtype)
        krope[rows, at] = k_rope[:, 0].to(krope.dtype)
    else:  # only the rank holding the position writes it
        _write_row(ckv, rows, at, base, c[:, 0])
        _write_row(krope, rows, at, base, k_rope[:, 0])
    if cfg.mla_absorb:
        return _mla_decode_absorbed(params, q_nope, q_rope, ckv, krope, pos, cfg,
                                    group, base=base, seq=seq), cache
    cols = base + torch.arange(ckv.shape[1], device=x.device)
    if per_slot:
        mask = cols[None, None, :] <= pos[:, None, None]  # (B, 1, T)
    else:
        mask = (cols <= pos)[None, :]  # (1, T)
    return _mla_attend(params, q_nope, q_rope, ckv, krope, cfg, mask, group, seq=seq), cache


def _mla_decode_absorbed(params, q_nope, q_rope, ckv, krope, pos, cfg: ModelConfig,
                         group=None, *, base: int = 0, seq=None):
    """Weight-absorbed MLA decode (the same math): W_uk is absorbed into
    the query and W_uv into the output, so attention runs against the
    compressed ``(r + dr)``-wide cache instead of recovering
    ``2·T·H·(dn + dv)`` K/V values. bf16 operands with f32 products and
    sums (JAX's ``preferred_element_type=f32``). With a TP ``group``,
    this rank's heads (its columns of ``w_uk``/``w_uv``), and ``wo``'s
    partial sums reduced over it. With a slot group ``seq``, ``ckv`` and
    ``krope`` are this rank's block of the positions from ``base`` on,
    the softmax and the weighted sum of ``ckv`` combined over ``seq``."""
    B = q_nope.shape[0]
    H, r = _mla_heads(params, cfg), cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    T = ckv.shape[1]
    w_uk = cast(params["w_uk"]).reshape(r, H, dn)
    w_uv = cast(params["w_uv"]).reshape(r, H, dv)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_uk.float())  # (B,H,r)
    s = (
        torch.einsum("bhr,btr->bht", q_c.to(ckv.dtype).float(), ckv.float())
        + torch.einsum("bhd,btd->bht", q_rope[:, 0].to(krope.dtype).float(), krope.float())
    ) * (dn + dr) ** -0.5
    pos_b = pos.reshape(-1, 1)  # (B,1) or (1,1)
    mask = (base + torch.arange(T, device=ckv.device)[None, :] <= pos_b)[:, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = _slot_softmax(s, seq)
    o_c = _slot_sum(torch.einsum("bht,btr->bhr", p.to(ckv.dtype).float(), ckv.float()),
                    seq)  # (B,H,r)
    out = torch.einsum("bhr,rhd->bhd", o_c, w_uv.float())
    return reduce_from_tp(out.reshape(B, 1, H * dv).to(q_nope.dtype) @ cast(params["wo"]), group)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {
        "wq": normal(gen, (d, H * Dh), d ** -0.5, device),
        "wk": normal(gen, (d, H * Dh), d ** -0.5, device),
        "wv": normal(gen, (d, H * Dh), d ** -0.5, device),
        "wo": normal(gen, (H * Dh, d), (H * Dh) ** -0.5, device),
    }


def cross_attn_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d) decoder states
    enc: torch.Tensor,  # (B, T, d) encoder output
    cfg: ModelConfig,
) -> torch.Tensor:
    """Every decoder position attends to every encoder row (no mask),
    scores and softmax in f32; the output is cast back to ``x``'s dtype
    before ``wo``. On a live TP group split by heads (``wq``/``wk``/``wv``
    column blocks, ``wo`` a row block whose partial sums are reduced;
    ``x`` and the replicated encoder output through ``copy_to_tp``), or
    with ``attn_seq_shard`` by decoder rows, each rank attending for its
    block of them with every head and the weights whole, as
    :func:`gqa_apply`'s sequence-sharded form."""
    B, S, _ = x.shape
    T = enc.shape[1]
    Dh = cfg.resolved_head_dim
    seq = _seq_group(cfg)
    group = _tp_heads_group(cfg) if seq is None else seq
    start, stop = (0, S) if seq is None else _row_block(S, seq)
    w = params
    if seq is not None:
        w = _whole_weights(params, cfg, ("wq", "wk", "wv", "wo"), seq, kv_heads=cfg.num_heads)
    x = copy_to_tp(x, group)[:, start:stop]
    enc = copy_to_tp(enc, group)
    # a decode step's encoder output is the bf16 cache leaf: JAX's promotion
    H = w["wq"].shape[1] // Dh  # this rank's heads, or all of them
    q = matmul(x, w["wq"]).reshape(B, stop - start, H, Dh)
    k = matmul(enc, w["wk"]).reshape(B, T, H, Dh)
    v = matmul(enc, w["wv"]).reshape(B, T, H, Dh)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (Dh ** -0.5)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    out = out.reshape(B, stop - start, H * Dh).to(x.dtype) @ cast(w["wo"])
    return reduce_from_tp(out, group) if seq is None else _rows_out(out, start, S, seq)
