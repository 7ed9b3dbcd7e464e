"""Tensor-parallel serving in the process form: what each spawned rank
runs, for ``tests/test_torch_tp_serve.py`` (gloo ranks on the CPU).

Spawned ranks import this module, so it imports torch and the port
only. Every function returns numpy arrays and plain numbers; the tests
hold them against the port at TP = 1 and against JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _tp_cases import compute_dtype, mesh_info

# the eight families TP serves: dense (four), MoE, MLA + MoE, Mamba-2,
# hybrid (jamba cut to its first 5 smoke layers, as in
# tests/_tp_family_cases.LAYERS: Mamba with a dense FFN and with a MoE,
# twice, then its GQA layer)
ARCHS = ("yi-6b", "llama3-8b", "h2o-danube-1.8b", "starcoder2-3b", "deepseek-moe-16b",
         "deepseek-v2-lite-16b", "mamba2-2.7b", "jamba-v0.1-52b")
LAYERS = {"jamba-v0.1-52b": 5}
# edge configs: a window of 18 below MAX_SEQ, whose ring buffer wraps
# during decode (the smoke window of 8 wraps at prefill already), and
# the absorbed MLA decode
EDGES = {"h2o_window_18": ("h2o-danube-1.8b", dict(sliding_window=18)),
         "mla_absorb": ("deepseek-v2-lite-16b", dict(mla_absorb=True))}
NAMES = ARCHS + tuple(EDGES)
# the archs with flat-dispatch MoE layers: over a live data axis their
# capacity is the global batch's, so a DP rank's TP = 1 reference is the
# whole batch's run, cut to the rank's rows
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
# the (data=2, model=1) mesh of the world2 spawn serves the MoE arch alone
DP_NAMES = ("deepseek-moe-16b",)
# qwen2-vl (embeds at M-RoPE positions) and whisper (tokens and encoder
# frames), served at scalar positions (no admission: neither package
# decodes M-RoPE per slot, and write_cache_slot refuses whisper's enc
# leaf), and whisper with 6 heads (H·Dh = 96) under JAX's opt-seq
# variant: 1.5 heads a rank at TP = 4, sequence-sharded
FIXED = ("qwen2-vl-7b", "whisper-tiny", "whisper_6_heads_opt_seq")
FIXED_EDGES = {"whisper_6_heads_opt_seq": ("whisper-tiny", "opt-seq",
                                           dict(num_heads=6, num_kv_heads=6))}
FIXED_MESHES = ("1x4", "2x2")  # the 4-rank spawn's meshes, JAX's
B, S = 4, 16  # the global batch of prompts
STEPS = 4  # greedy decode steps at each kind of position
SLOT, SLOT_LEN = 1, 8  # the admission: a DP rank's local slot, its prompt's length
MAX_SEQ = 32  # S + 2·STEPS + 2 decode positions fit
# the cells on a ProcessMesh: the assigned shapes for all ten archs, and
# one family each at smoke size
CELL_ARCHS = ARCHS + ("qwen2-vl-7b", "whisper-tiny")
CELL_SHAPES = ("prefill_32k", "decode_32k")
# the archs whose opt-seq cells (attn_seq_shard) build on (1, 4): every
# GQA arch
OPT_SEQ_ARCHS = ("yi-6b", "llama3-8b", "h2o-danube-1.8b", "starcoder2-3b", "deepseek-moe-16b",
                 "jamba-v0.1-52b", "qwen2-vl-7b", "whisper-tiny")
SMOKE_CELL_ARCHS = ("yi-6b", "deepseek-moe-16b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                    "jamba-v0.1-52b")
SMOKE_SHAPES = {"prefill_smoke": ("prefill", 16, 2), "decode_smoke": ("decode", 16, 2),
                "long_smoke": ("decode", 64, 1)}
# long_500k at smoke size: one sequence (replicated on every rank), its
# cache's LONG_SLOTS slots split over data (a count divisible by 16, as
# cache_pspecs needs to split it)
LONG_SHAPE = "long_smoke"
LONG_SLOTS = SMOKE_SHAPES[LONG_SHAPE][1]
# the long-context configs decoded from a seeded whole cache: jamba (its
# GQA layer, its flat MoE under the one replicated token), h2o-danube
# with a window of 32 (a ring buffer), deepseek-v2-lite's MLA and
# mamba2 (nothing split over data)
LONG_EDGES = {"h2o_window_32": ("h2o-danube-1.8b", dict(sliding_window=32))}
LONG_NAMES = ("jamba-v0.1-52b", "h2o_window_32", "deepseek-v2-lite-16b", "mamba2-2.7b")
LONG_MESHES = ("1x2", "2x1", "2x2")
LONG_CELL_ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b", "h2o-danube-1.8b")  # long_500k's archs
# cells once refused on a ProcessMesh and what each does now: the arch,
# the shape, the mesh it is asked on, and the words of its refusal
# (None: it builds)
CELL_REFUSALS = {"train": ("qwen2-vl-7b", "train_4k", "1x2", None),
                 "long_500k": ("mamba2-2.7b", "long_500k", "1x2", None),
                 "qwen2-vl-7b": ("qwen2-vl-7b", "prefill_32k", "1x2", None),
                 "whisper-tiny": ("whisper-tiny", "decode_32k", "1x4",
                                  ("num_heads=6", "attn_seq_shard")),
                 "moe_over_data": ("deepseek-moe-16b", "decode_32k", "2x2", None)}


def flat_moe(cfg) -> bool:
    """Whether ``cfg`` has MoE layers on the flat dispatch (whose capacity
    over a live ``data`` axis is the global batch's)."""
    return (any(s.ffn == "moe" for pattern, _ in cfg.layer_groups() for s in pattern)
            and not (cfg.moe_row_dispatch or cfg.moe_ep_dispatch))


def config(name: str):
    """The smoke config of an arch of :data:`ARCHS` or :data:`FIXED`
    (cut to ``LAYERS``) or of an edge config (a variant's overrides,
    then the edge's)."""
    from repro_torch import configs as C
    from repro_torch.launch.steps import VARIANTS

    if name in LONG_EDGES:
        arch, changes = LONG_EDGES[name]
        return dataclasses.replace(C.get_smoke_config(arch), **changes)
    if name in FIXED_EDGES:
        arch, variant, changes = FIXED_EDGES[name]
        return dataclasses.replace(C.get_smoke_config(arch), **VARIANTS[variant], **changes)
    if name in EDGES:
        arch, changes = EDGES[name]
        return dataclasses.replace(C.get_smoke_config(arch), **changes)
    cfg = C.get_smoke_config(name)
    return dataclasses.replace(cfg, num_layers=LAYERS.get(name, cfg.num_layers))


def init_params(cfg) -> dict:
    """``cfg``'s params, drawn by the port from seed 0, as numpy."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_tree

    return map_tree(lambda t: t.numpy(), T.model_init(torch.Generator().manual_seed(0), cfg,
                                                      "cpu"))


def prompts(vocab: int) -> np.ndarray:
    """The global batch of prompts (B, S)."""
    return np.random.default_rng(1).integers(0, vocab, (B, S)).astype(np.int32)


def slot_prompt(vocab: int, dp_index: int) -> np.ndarray:
    """The (1, SLOT_LEN) prompt DP rank ``dp_index`` admits."""
    return np.random.default_rng(10 + dp_index).integers(0, vocab, (1, SLOT_LEN)).astype(
        np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy().copy()


def _leaves_np(tree) -> list[np.ndarray]:
    from repro_torch.tree import leaves

    return [_np(t) for t in leaves(tree)]


def serve(cfg, params, rows: np.ndarray, slot: np.ndarray, device, mesh=None,
          given: dict | None = None, slot_rows: tuple[int, ...] = (SLOT,)) -> dict:
    """The traffic of one DP rank's rows in f32 compute: a prefill of
    ``rows``, STEPS greedy ``make_serve_step`` steps at scalar positions,
    one ``decode_step`` for its logits, an admission of ``slot`` (one
    prompt a row, each prefilled as its own batch, as a rank admits its
    own) into local slots ``slot_rows`` (``make_slot_prefill_step``,
    ``write_cache_slot``),
    STEPS steps at per-slot positions and one more ``decode_step``. On
    ``mesh`` (a ``ProcessMesh``) the rank's shards serve its rows under
    ``set_mesh``; the caches come back gathered (``gather_cache``).

    A cache stores a bf16 rounding of f32 values, which another TP size
    computes in another summation order, so an element may round to the
    neighbouring bf16 value. With ``given`` (the TP = 1 run's record),
    each stage whose logits are compared starts from the cache that run
    had there, placed on this rank (``place_cache``): the decode after
    the prefill, the ``decode_step`` after each run of steps, and the
    admitted row. Each stage's logits are then one function of the same
    inputs. Returns the logits, tokens and caches of each stage, the
    model group's payload bytes of the prefill, of the first decode step
    and of the admission, and this rank's own cache leaves."""
    from repro_torch import configs as C
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_slot_prefill_step, write_cache_slot)
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.parallel.spec import keep_axes
    from repro_torch.tree import leaves, map_tree, paths, unflatten

    n, k = rows.shape[0], slot.shape[0]
    tp = 1 if mesh is None else mesh.shape["model"]
    # the specs of this DP rank's cache: its rows are the whole batch here
    specs = {b: map_tree(lambda sp: keep_axes(sp, ("model",)), shd.logical_cache_pspecs(
        cfg, C.SHAPES["decode_32k"], b, MAX_SEQ, tp)) for b in {n, k}}

    def whole(cache, b=n):
        return _leaves_np(cache if mesh is None else shd.gather_cache(cache, specs[b], cfg, mesh))

    def placed(cache, key, b=n):
        """``given[key]`` on this rank, or ``cache`` without ``given``."""
        if given is None:
            return cache
        with hints.set_mesh(None):
            like = T.init_cache(cfg, b, MAX_SEQ, device="meta")
        logical = unflatten(like, [torch.from_numpy(a).to(device=device, dtype=x.dtype)
                                   for a, x in zip(given[key], leaves(like))])
        return shd.place_cache(logical, specs[b], cfg, mesh) if mesh is not None else logical

    out: dict = {}
    prefill = make_prefill_step(cfg, MAX_SEQ)
    step = make_serve_step(cfg)
    with torch.no_grad(), hints.set_mesh(mesh), compute_dtype(torch.float32):
        tp_counter.reset()
        logits, cache = prefill(params, {"tokens": torch.from_numpy(rows).to(device)})
        out["prefill_bytes"] = dict(tp_counter.bytes)
        out["prefill_logits"] = _np(logits)
        out["prefill_cache"] = whole(cache)
        cache = placed(cache, "prefill_cache")
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks = []
        for i in range(STEPS):
            tp_counter.reset()
            tok, cache = step(params, tok, torch.tensor(S + i, dtype=torch.int32), cache)
            if i == 0:
                out["decode_bytes"] = dict(tp_counter.bytes)
            toks.append(tok.cpu().numpy().copy())
        out["tokens"] = toks
        out["decode_cache"] = whole(cache)
        cache = placed(cache, "decode_cache")
        logits, cache = T.decode_step(params, cfg, tok, torch.tensor(S + STEPS), cache)
        out["decode_logits"] = _np(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)

        # an admission into local slot SLOT, then per-slot positions
        tp_counter.reset()
        # each admitted prompt is its own batch (one rank's admission)
        admitted = [make_slot_prefill_step(cfg, MAX_SEQ)(params, torch.from_numpy(
            slot[j:j + 1]).to(device)) for j in range(k)]
        first = torch.cat([a[0] for a in admitted])
        one = map_tree(lambda *xs: torch.cat(xs, 1), *[a[1] for a in admitted])
        out["slot_bytes"] = dict(tp_counter.bytes)
        out["slot_token"] = first.cpu().numpy().copy()
        out["slot_cache"] = whole(one, k)
        one = placed(one, "slot_cache", k)
        pos = torch.full((n,), S + STEPS + 1, dtype=torch.int32)
        for j, row in enumerate(slot_rows):
            write_cache_slot(cache, map_tree(lambda x, j=j: x[:, j:j + 1], one), row)
            tok[row] = first[j]
            pos[row] = SLOT_LEN
        slot_toks = []
        for i in range(STEPS):
            tok, cache = step(params, tok, (pos + i).to(device), cache)
            slot_toks.append(tok.cpu().numpy().copy())
        out["slot_tokens"] = slot_toks
        out["slot_steps_cache"] = whole(cache)
        cache = placed(cache, "slot_steps_cache")
        logits, cache = T.decode_step(params, cfg, tok, (pos + STEPS).to(device), cache)
        out["slot_logits"] = _np(logits)
        out["final_cache"] = whole(cache)
        out["local_cache"] = _leaves_np(cache)
        out["cache_keys"] = [p[-1] for p, _ in paths(cache)]
        if mesh is not None:
            out["cache_replicated"] = replicated_leaves(cfg, specs[n], mesh)
    return out


def fixed_batch(cfg) -> dict:
    """The global prompt batch of a :data:`FIXED` config: a vlm's random
    embeddings at image-then-text M-RoPE positions (a 2 x 4 grid, then
    text), whisper's tokens and random encoder frames."""
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        i = np.arange(8)
        pos = np.concatenate([np.stack([0 * i, i // 4, i % 4]),
                              np.broadcast_to(4 + np.arange(S - 8), (3, S - 8))], 1)
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "positions": np.ascontiguousarray(
                    np.broadcast_to(pos[:, None], (3, B, S))).astype(np.int32)}
    return {"tokens": prompts(cfg.vocab_size),
            "enc_frames": rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(
                np.float32)}


def rank_rows(batch: dict, dp: int, i: int) -> dict:
    """DP rank ``i``'s rows of a batch (M-RoPE positions on axis 1)."""
    n = B // dp
    return {k: v[:, i * n:(i + 1) * n] if k == "positions" else v[i * n:(i + 1) * n]
            for k, v in batch.items()}


def serve_fixed(cfg, params, rows: dict, device, mesh=None, given: dict | None = None) -> dict:
    """The traffic of one DP rank's ``rows`` of a :data:`FIXED` config in
    f32 compute: a prefill, STEPS greedy steps at scalar positions and
    one ``decode_step`` for its logits; on ``mesh`` under ``set_mesh``,
    the caches gathered; with ``given`` (the TP = 1 record) the decode
    starts from its prefill cache and the last ``decode_step`` from its
    steps' cache, placed on the rank (as :func:`serve`). Then one
    ``decode_step`` in bf16 compute from the prefill's own cache
    (``bf16_decode_logits``: JAX's scalar decode writes its bf16 cache
    only in bf16 compute). Returns logits, tokens, caches and the model
    group's payload of the prefill and the first step."""
    from repro_torch import configs as C
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import keep_axes
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.tree import leaves, map_tree, paths, unflatten

    n = rows["embeds"].shape[0] if "embeds" in rows else rows["tokens"].shape[0]
    tp = 1 if mesh is None else mesh.shape["model"]
    specs = map_tree(lambda sp: keep_axes(sp, ("model",)), shd.logical_cache_pspecs(
        cfg, C.SHAPES["decode_32k"], n, MAX_SEQ, tp))

    def whole(cache):
        return _leaves_np(cache if mesh is None else shd.gather_cache(cache, specs, cfg, mesh))

    def placed(cache, key):
        if given is None:
            return cache
        with hints.set_mesh(None):
            like = T.init_cache(cfg, n, MAX_SEQ, device="meta")
        logical = unflatten(like, [torch.from_numpy(a).to(device=device, dtype=x.dtype)
                                   for a, x in zip(given[key], leaves(like))])
        return shd.place_cache(logical, specs, cfg, mesh) if mesh is not None else logical

    batch = {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
    step = make_serve_step(cfg)
    out: dict = {}
    with torch.no_grad(), hints.set_mesh(mesh):
        with compute_dtype(torch.float32):
            tp_counter.reset()
            logits, cache = make_prefill_step(cfg, MAX_SEQ)(params, batch)
            out["prefill_bytes"] = dict(tp_counter.bytes)
            out["prefill_logits"] = _np(logits)
            out["prefill_cache"] = whole(cache)
            first = torch.argmax(logits, -1).to(torch.int32)
            cache = placed(cache, "prefill_cache")
            fresh = map_tree(torch.clone, cache)
            tok, toks = first, []
            for i in range(STEPS):
                tp_counter.reset()
                tok, cache = step(params, tok, torch.tensor(S + i, dtype=torch.int32), cache)
                if i == 0:
                    out["decode_bytes"] = dict(tp_counter.bytes)
                toks.append(tok.cpu().numpy().copy())
            out["tokens"] = toks
            out["decode_cache"] = whole(cache)
            cache = placed(cache, "decode_cache")
            logits, cache = T.decode_step(params, cfg, tok, torch.tensor(S + STEPS), cache)
            out["decode_logits"] = _np(logits)
            out["final_cache"] = whole(cache)
            out["local_cache"] = _leaves_np(cache)
        logits, fresh = T.decode_step(params, cfg, first, torch.tensor(S), fresh)
        out["bf16_decode_logits"] = _np(logits)
    out["cache_keys"] = [p[-1] for p, _ in paths(cache)]
    if mesh is not None:
        out["cache_replicated"] = replicated_leaves(cfg, specs, mesh)
    return out


def fixed_case(mesh, name: str, params_np: dict, device) -> dict:
    """:func:`serve_fixed` of config ``name`` on ``mesh``: the port at
    TP = 1 on this rank's DP rows first (``ref``), then the same on its
    shards given that run's caches; plus the modeled payload bytes."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import modeled_tp_serve_bytes

    cfg = config(name)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    rows = rank_rows(fixed_batch(cfg), dp, mesh.dp_index)
    ref = serve_fixed(cfg, params_from_numpy(params_np, device), rows, device)
    params = params_from_numpy(params_np, device, specs=shd.logical_pspecs(cfg, tp), mesh=mesh)
    out = serve_fixed(cfg, params, rows, device, mesh, given=ref)
    out["ref"] = {k: v for k, v in ref.items() if not k.endswith("bytes")}
    with compute_dtype(torch.float32):
        out["modeled"] = {"prefill": modeled_tp_serve_bytes(cfg, B // dp, S, tp),
                          "decode": modeled_tp_serve_bytes(cfg, B // dp, 1, tp)}
    out["dp_index"] = mesh.dp_index
    return out


def round_trip(cfg, mesh, device) -> dict:
    """A logical cache of the global batch (B rows, random values from a
    seed, the same on every rank) through ``place_cache`` and back
    through ``gather_cache``, over ``data`` and ``model``: whether every
    leaf comes back bit for bit, and the placed shapes."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves, unflatten

    gen = torch.Generator().manual_seed(3)
    with hints.set_mesh(None):
        like = T.init_cache(cfg, B, MAX_SEQ, device="meta")
    logical = unflatten(like, [torch.randn(x.shape, generator=gen).to(device=device,
                                                                       dtype=x.dtype)
                               for x in leaves(like)])
    specs = shd.logical_cache_pspecs(cfg, C.SHAPES["decode_32k"], B, MAX_SEQ,
                                     mesh.shape["model"])
    placed = shd.place_cache(logical, specs, cfg, mesh)
    back = shd.gather_cache(placed, specs, cfg, mesh)
    return {"round_trip_equal": all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                                      leaves(logical))),
            "placed_shapes": [tuple(x.shape) for x in leaves(placed)]}


def replicated_leaves(cfg, specs, mesh) -> list[bool]:
    """Which leaves of a decode cache every rank of a TP group holds
    whole: those no spec splits over ``model`` (``ckv``/``krope``, K/V
    whose heads the TP size does not divide), but for a Mamba-2 layer's
    ``conv`` window where ``d_inner`` is split (the rank's own layout,
    ``sharding.place_cache``)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import paths

    tp = mesh.shape["model"]
    mamba_split = tp > 1 and cfg.d_inner % tp == 0
    return [not shd.is_split(s, mesh) and not (p[-1] == "conv" and mamba_split)
            for p, s in paths(specs)]


def _cut(rec: dict, rows: slice, i: int) -> dict:
    """A TP = 1 record of the whole batch (every DP rank's rows and
    admissions) cut to DP rank ``i``'s: its ``rows``, its admission
    ``i``."""
    out = {}
    for key, v in rec.items():
        if key in ("tokens", "slot_tokens"):
            out[key] = [t[rows] for t in v]
        elif key == "slot_token":
            out[key] = v[i:i + 1]
        elif key == "slot_cache":
            out[key] = [x[:, i:i + 1] for x in v]
        elif key.endswith("cache"):
            out[key] = [x[:, rows] for x in v]
        elif key.endswith("logits"):
            out[key] = v[rows]
        else:
            out[key] = v
    return out


def serve_case(mesh, name: str, params_np: dict, device) -> dict:
    """:func:`serve` of config ``name`` on ``mesh`` from the logical
    ``params_np``: first the port at TP = 1 on this rank's DP rows of
    :func:`prompts` and its admission (``ref``), then the same on this
    rank's shards (``param_pspecs`` placed by ``params_from_numpy``),
    given that run's caches; plus the modeled payload bytes. A MoE arch
    over a live ``data`` axis takes the global batch's capacity in its
    prefill and decode, so its reference is the TP = 1 run of the whole
    batch, with every DP rank's admission prefilled alone (a slot
    prefill's capacity is its one prompt's), cut to this rank's
    (:func:`_cut`)."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import modeled_tp_serve_bytes

    cfg = config(name)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    n, i = B // dp, mesh.dp_index
    rows = prompts(cfg.vocab_size)[i * n:(i + 1) * n]
    slot = slot_prompt(cfg.vocab_size, i)
    whole_params = params_from_numpy(params_np, device)
    if dp > 1 and flat_moe(cfg):
        slots = np.concatenate([slot_prompt(cfg.vocab_size, j) for j in range(dp)])
        ref = _cut(serve(cfg, whole_params, prompts(cfg.vocab_size), slots, device,
                         slot_rows=tuple(j * n + SLOT for j in range(dp))),
                   slice(i * n, (i + 1) * n), i)
    else:
        ref = serve(cfg, whole_params, rows, slot, device)
    params = params_from_numpy(params_np, device, specs=shd.logical_pspecs(cfg, tp), mesh=mesh)
    out = serve(cfg, params, rows, slot, device, mesh, given=ref)
    out["ref"] = {k: v for k, v in ref.items() if not k.endswith("bytes")}
    out.update(round_trip(cfg, mesh, device))
    with compute_dtype(torch.float32):
        out["modeled"] = {"prefill": modeled_tp_serve_bytes(cfg, n, S, tp, dp=dp),
                          "decode": modeled_tp_serve_bytes(cfg, n, 1, tp, dp=dp),
                          "slot": modeled_tp_serve_bytes(cfg, 1, SLOT_LEN, tp)}
    out["dp_index"] = mesh.dp_index
    return out


# ---------------------------------------------------------------------------
# Long context: the sequence-parallel decode
# ---------------------------------------------------------------------------


def long_positions(name: str) -> tuple[int, ...]:
    """The decode positions of a long-context config: 0 (only slot 0, on
    data rank 0, is valid), one in the last data rank's block of the
    cache's slots, and, where the cache is a ring (GQA, Mamba-2's
    positionless state), one past its wrap; an MLA cache holds one slot
    a position and no wrap."""
    cfg = config(name)
    slots = min(LONG_SLOTS, cfg.sliding_window) if cfg.sliding_window else LONG_SLOTS
    last = slots - slots // 4 - 1  # in the last block on 2 data ranks
    if any(s.mixer == "mla" for pattern, _ in cfg.layer_groups() for s in pattern):
        return (0, last)
    return (0, last, slots + last - slots // 2)  # wrapped into rank 0's block


def long_cache(name: str) -> list[np.ndarray]:
    """The seeded whole decode cache of ``name`` (one row, LONG_SLOTS
    positions): each leaf's values, bf16 leaves rounded to bf16 (as f32
    arrays, exact), from seed 4."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.tree import leaves

    with hints.set_mesh(None):
        like = leaves(T.init_cache(config(name), 1, LONG_SLOTS, device="meta"))
    gen = torch.Generator().manual_seed(4)
    return [torch.randn(x.shape, generator=gen).to(x.dtype).float().numpy() for x in like]


def long_case(mesh, name: str, params_np: dict, cache_np: list, device) -> dict:
    """The one-token decode of ``name`` from its seeded whole cache
    (``cache_np``) at each of :func:`long_positions`, in f32 compute: on
    this rank's shards and its block of the cache placed by
    ``cache_pspecs`` of the long shape (slots over ``data``), under
    ``hints.replicated_batch`` (as ``build_cell``'s long_500k step runs),
    and on the whole params and cache with no mesh (``ref``). Returns
    per position the logits, the greedy token, the new cache gathered
    (``gather_cache``), the model group's payload and the token counts
    the MoE capacity was taken for; the placed leaves' shapes."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import Shape
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import modeled_tp_serve_bytes, tp_counter
    from repro_torch.tree import leaves, unflatten

    cfg = config(name)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    shape = Shape(LONG_SHAPE, "decode", LONG_SLOTS, 1)
    with hints.set_mesh(None):
        like = T.init_cache(cfg, 1, LONG_SLOTS, device="meta")
    specs = shd.cache_pspecs(like, cfg, shape, tp=tp)

    def whole():  # a fresh copy: the decode writes its cache in place
        return unflatten(like, [torch.tensor(a, device=device).to(x.dtype)
                                for a, x in zip(cache_np, leaves(like))])

    whole_params = params_from_numpy(params_np, device)
    params = params_from_numpy(params_np, device, specs=shd.logical_pspecs(cfg, tp), mesh=mesh)
    tok = torch.tensor([7], dtype=torch.int32, device=device)
    capacity, seen = M.capacity, []

    def recording(cfg_, tokens):
        seen.append(tokens)
        return capacity(cfg_, tokens)

    out = {"ref": {}}
    with torch.no_grad(), compute_dtype(torch.float32):
        for pos in long_positions(name):
            p = torch.tensor(pos, dtype=torch.int32)
            logits, cache = T.decode_step(whole_params, cfg, tok, p, whole())
            out["ref"][pos] = {"logits": _np(logits), "cache": _leaves_np(cache)}
            placed = shd.place_cache(whole(), specs, cfg, mesh)
            tp_counter.reset()
            seen.clear()
            M.capacity = recording
            try:
                with hints.set_mesh(mesh), hints.replicated_batch():
                    logits, placed = T.decode_step(params, cfg, tok, p, placed)
            finally:
                M.capacity = capacity
            out[pos] = {"bytes": dict(tp_counter.bytes), "capacity_tokens": list(seen),
                        "logits": _np(logits), "token": int(logits.argmax(-1)[0]),
                        "cache": _leaves_np(shd.gather_cache(placed, specs, cfg, mesh))}
        out["placed_shapes"] = [tuple(x.shape) for x in leaves(placed)]
        out["modeled"] = modeled_tp_serve_bytes(cfg, 1, 1, tp, slot_split=dp)
    out["cache_keys"] = [k for k in _cache_keys(like)]
    return out


def _cache_keys(cache) -> list[str]:
    from repro_torch.tree import paths

    return [p[-1] for p, _ in paths(cache)]


def long_cases(mesh, params_np: dict, caches_np: dict, device) -> dict:
    return {name: long_case(mesh, name, params_np[name], caches_np[name], device)
            for name in LONG_NAMES}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def register_smoke_shapes():
    """Add :data:`SMOKE_SHAPES` to ``configs.SHAPES`` (a spawned rank's
    own copy; the test registers them in its process with
    ``monkeypatch``)."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import Shape

    for name, (kind, seq, batch) in SMOKE_SHAPES.items():
        C.SHAPES[name] = Shape(name, kind, seq, batch)


def _shapes(tree) -> list[tuple]:
    from repro_torch.tree import leaves

    return [tuple(x.shape) for x in leaves(tree)]


def _refused(build) -> str | None:
    """The message ``build()`` raises ``NotImplementedError`` with, or
    ``None`` where it builds."""
    try:
        build()
    except NotImplementedError as e:
        return str(e)
    return None


def meta_cells(mesh) -> dict:
    """``build_cell`` on ``mesh`` for every arch of :data:`CELL_ARCHS` at
    :data:`CELL_SHAPES` on the meta device, below TP = 4 the long_500k
    cells of :data:`LONG_CELL_ARCHS`, and at TP = 4 the ``opt-seq``
    cells of :data:`OPT_SEQ_ARCHS`: each arg's leaf shapes and the
    cell's specs, or the message of a refusal."""
    from repro_torch.launch.steps import build_cell

    out = {}
    jobs = [(arch, shape, "baseline") for arch in CELL_ARCHS for shape in CELL_SHAPES]
    if mesh.shape["model"] < 4:  # the meshes of LONG_MESHES
        jobs += [(arch, "long_500k", "baseline") for arch in LONG_CELL_ARCHS]
    if mesh.shape["model"] == 4:
        jobs += [(arch, shape, "opt-seq") for arch in OPT_SEQ_ARCHS for shape in CELL_SHAPES]
    for arch, shape, variant in jobs:
        key = f"{arch}/{shape}" + ("" if variant == "baseline" else f"/{variant}")
        try:
            cell = build_cell(arch, shape, mesh, variant=variant)
        except NotImplementedError as e:
            out[key] = {"refused": str(e)}
            continue
        assert all(x.device.type == "meta" for x in _flat(cell.args))
        out[key] = {"args": [_shapes(a) for a in cell.args],
                    "in_specs": [str(s) for s in _flat(cell.in_specs)],
                    "out_specs": [str(s) for s in _flat(cell.out_specs)]}
    return out


def _flat(tree):
    from repro_torch.tree import leaves

    return [x for x in leaves(tree) if x is not None]


def smoke_cells(mesh, device) -> dict:
    """One prefill and one decode cell of each arch of
    :data:`SMOKE_CELL_ARCHS` at smoke size on ``mesh``, run in f32
    compute: the prefill's logits and the decode's tokens of this rank's
    rows, and each one's cache of those rows gathered over the TP
    group."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import keep_axes
    from repro_torch.tree import map_tree

    register_smoke_shapes()
    out = {}
    for arch in SMOKE_CELL_ARCHS:
        for shape in SMOKE_SHAPES:
            cell = build_cell(arch, shape, mesh, smoke=True, device=device)
            kind, seq, batch = SMOKE_SHAPES[shape]
            if batch == 1:  # the one replicated row: its slots gathered over data too
                specs = shd.logical_cache_pspecs(cell.cfg, cell.shape, 1, seq,
                                                 mesh.shape["model"])
            else:  # the rank's rows: its TP group's blocks gathered, not the DP ranks'
                specs = map_tree(lambda sp: keep_axes(sp, ("model",)), shd.logical_cache_pspecs(
                    cell.cfg, cell.shape, batch // mesh.shape["data"], seq, mesh.shape["model"]))
            with torch.no_grad(), compute_dtype(torch.float32):
                first, cache = cell.step_fn(*cell.args)
            out[f"{arch}/{shape}"] = {
                "out": _np(first), "cache": _leaves_np(shd.gather_cache(cache, specs, cell.cfg,
                                                                        mesh))}
    return out


def cell_refusals(meshes: dict) -> dict:
    """The message each cell of :data:`CELL_REFUSALS` whose mesh is in
    ``meshes`` raises with there (``None`` where it builds)."""
    from repro_torch.launch.steps import build_cell

    return {name: _refused(lambda: build_cell(arch, shape, meshes[mesh]))
            for name, (arch, shape, mesh, _) in CELL_REFUSALS.items() if mesh in meshes}


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------


def _mesh_cases(mesh, params_np: dict, device, fixed: bool = True) -> dict:
    out = {"serve": {name: serve_case(mesh, name, params_np[name], device) for name in NAMES},
           "meta_cells": meta_cells(mesh), "smoke_cells": smoke_cells(mesh, device)}
    if fixed:
        out["fixed"] = {name: fixed_case(mesh, name, params_np[name], device) for name in FIXED}
    return out


def world4_rank(rank: int, world: int, device, params_np: dict, caches_np: dict) -> dict:
    """(data=1, model=4) and (data=2, model=2) on 4 ranks: every config
    served on both meshes, the cells, and the refusals asked on
    ``(2, 2)``; the long-context decode on ``(2, 2)``."""
    from repro_torch.launch.mesh import make_process_mesh

    meshes = {"1x4": make_process_mesh(model=4), "2x2": make_process_mesh(data=2, model=2)}
    out = {"mesh": {k: mesh_info(m) for k, m in meshes.items()},
           "cases": {k: _mesh_cases(m, params_np, device) for k, m in meshes.items()},
           "refusals": cell_refusals(meshes)}
    out["cases"]["2x2"]["long"] = long_cases(meshes["2x2"], params_np, caches_np, device)
    return out


def world2_rank(rank: int, world: int, device, params_np: dict, caches_np: dict) -> dict:
    """(data=1, model=2) on 2 ranks: every config served, the cells, and
    the refusals; (data=2, model=1): the MoE arch of :data:`DP_NAMES`
    served over data, its capacity the global batch's, and the
    long_500k meta cells; the long-context decode on both."""
    from repro_torch.launch.mesh import make_process_mesh

    mesh = make_process_mesh(model=2)
    dp2 = make_process_mesh(data=2)
    out = {"mesh": {"1x2": mesh_info(mesh)},
           "cases": {"1x2": _mesh_cases(mesh, params_np, device, fixed=False),
                     "2x1": {"serve": {name: serve_case(dp2, name, params_np[name], device)
                                       for name in DP_NAMES},
                             "meta_cells": long_meta_cells(dp2)}},
           "refusals": cell_refusals({"1x2": mesh})}
    out["cases"]["1x2"]["long"] = long_cases(mesh, params_np, caches_np, device)
    out["cases"]["2x1"]["long"] = long_cases(dp2, params_np, caches_np, device)
    return out


def long_meta_cells(mesh) -> dict:
    """:func:`meta_cells`' record of the long_500k cells of
    :data:`LONG_CELL_ARCHS` alone."""
    from repro_torch.launch.steps import build_cell

    out = {}
    for arch in LONG_CELL_ARCHS:
        cell = build_cell(arch, "long_500k", mesh)
        out[f"{arch}/long_500k"] = {"args": [_shapes(a) for a in cell.args],
                                    "in_specs": [str(s) for s in _flat(cell.in_specs)],
                                    "out_specs": [str(s) for s in _flat(cell.out_specs)]}
    return out
