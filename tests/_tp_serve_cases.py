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
# the archs with flat-dispatch MoE layers, whose cells build_cell refuses
# on a mesh with data > 1 (ROADMAP 9c, entry 10)
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")
B, S = 4, 16  # the global batch of prompts
STEPS = 4  # greedy decode steps at each kind of position
SLOT, SLOT_LEN = 1, 8  # the admission: a DP rank's local slot, its prompt's length
MAX_SEQ = 32  # S + 2·STEPS + 2 decode positions fit
# the cells on a ProcessMesh: the assigned shapes, and one family each at
# smoke size
CELL_ARCHS = ARCHS
CELL_SHAPES = ("prefill_32k", "decode_32k")
SMOKE_CELL_ARCHS = ("yi-6b", "deepseek-moe-16b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                    "jamba-v0.1-52b")
SMOKE_SHAPES = {"prefill_smoke": ("prefill", 16, 2), "decode_smoke": ("decode", 16, 2)}
# what still raises on a ProcessMesh with a live model axis: the arch,
# the shape, the ROADMAP 9c entry it names and the mesh it is asked on
CELL_REFUSALS = {"train": ("qwen2-vl-7b", "train_4k", 2, "1x2"),
                 "long_500k": ("mamba2-2.7b", "long_500k", 9, "1x2"),
                 "qwen2-vl-7b": ("qwen2-vl-7b", "prefill_32k", 2, "1x2"),
                 "whisper-tiny": ("whisper-tiny", "decode_32k", 3, "1x2"),
                 "moe_over_data": ("deepseek-moe-16b", "decode_32k", 10, "2x2")}


def config(name: str):
    """The smoke config of an arch of :data:`ARCHS` (cut to ``LAYERS``)
    or of an edge config."""
    from repro_torch import configs as C

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
          given: dict | None = None) -> dict:
    """The traffic of one DP rank's rows in f32 compute: a prefill of
    ``rows``, STEPS greedy ``make_serve_step`` steps at scalar positions,
    one ``decode_step`` for its logits, an admission of ``slot`` into
    local slot SLOT (``make_slot_prefill_step``, ``write_cache_slot``),
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

    n = rows.shape[0]
    tp = 1 if mesh is None else mesh.shape["model"]
    # the specs of this DP rank's cache: its rows are the whole batch here
    specs = {b: map_tree(lambda sp: keep_axes(sp, ("model",)), shd.logical_cache_pspecs(
        cfg, C.SHAPES["decode_32k"], b, MAX_SEQ, tp)) for b in (n, 1)}

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
        first, one = make_slot_prefill_step(cfg, MAX_SEQ)(params, torch.from_numpy(slot).to(
            device))
        out["slot_bytes"] = dict(tp_counter.bytes)
        out["slot_token"] = int(first[0])
        out["slot_cache"] = whole(one, 1)
        write_cache_slot(cache, placed(one, "slot_cache", 1), SLOT)
        tok[SLOT] = first[0]
        pos = torch.full((n,), S + STEPS + 1, dtype=torch.int32)
        pos[SLOT] = SLOT_LEN
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


def serve_case(mesh, name: str, params_np: dict, device) -> dict:
    """:func:`serve` of config ``name`` on ``mesh`` from the logical
    ``params_np``: first the port at TP = 1 on this rank's DP rows of
    :func:`prompts` and its admission (``ref``), then the same on this
    rank's shards (``param_pspecs`` placed by ``params_from_numpy``),
    given that run's caches; plus the modeled payload bytes."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import modeled_tp_serve_bytes

    cfg = config(name)
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    n = B // dp
    rows = prompts(cfg.vocab_size)[mesh.dp_index * n:(mesh.dp_index + 1) * n]
    slot = slot_prompt(cfg.vocab_size, mesh.dp_index)
    ref = serve(cfg, params_from_numpy(params_np, device), rows, slot, device)
    params = params_from_numpy(params_np, device, specs=shd.logical_pspecs(cfg, tp), mesh=mesh)
    out = serve(cfg, params, rows, slot, device, mesh, given=ref)
    out["ref"] = {k: v for k, v in ref.items() if not k.endswith("bytes")}
    out.update(round_trip(cfg, mesh, device))
    with compute_dtype(torch.float32):
        out["modeled"] = {"prefill": modeled_tp_serve_bytes(cfg, n, S, tp),
                          "decode": modeled_tp_serve_bytes(cfg, n, 1, tp),
                          "slot": modeled_tp_serve_bytes(cfg, 1, SLOT_LEN, tp)}
    out["dp_index"] = mesh.dp_index
    return out


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
    :data:`CELL_SHAPES` on the meta device: each arg's leaf shapes and
    the cell's specs; for a MoE arch on a mesh with ``data`` > 1, which
    ``build_cell`` refuses, the message."""
    from repro_torch.launch.steps import build_cell

    out = {}
    for arch in CELL_ARCHS:
        for shape in CELL_SHAPES:
            if mesh.shape["data"] > 1 and arch in MOE_ARCHS:
                out[f"{arch}/{shape}"] = {"refused": _refused(lambda: build_cell(arch, shape,
                                                                                 mesh))}
                continue
            cell = build_cell(arch, shape, mesh)
            assert all(x.device.type == "meta" for x in _flat(cell.args))
            out[f"{arch}/{shape}"] = {"args": [_shapes(a) for a in cell.args],
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
    group; for a MoE arch on a mesh with ``data`` > 1 the message
    ``build_cell`` refuses with."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import keep_axes
    from repro_torch.tree import map_tree

    register_smoke_shapes()
    out = {}
    for arch in SMOKE_CELL_ARCHS:
        for shape in SMOKE_SHAPES:
            if mesh.shape["data"] > 1 and arch in MOE_ARCHS:
                out[f"{arch}/{shape}"] = {"refused": _refused(lambda: build_cell(
                    arch, shape, mesh, smoke=True, device=device))}
                continue
            cell = build_cell(arch, shape, mesh, smoke=True, device=device)
            kind, seq, batch = SMOKE_SHAPES[shape]
            # the rank's rows: its TP group's blocks gathered, not the DP ranks'
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
            for name, (arch, shape, _, mesh) in CELL_REFUSALS.items() if mesh in meshes}


# ---------------------------------------------------------------------------
# The worlds
# ---------------------------------------------------------------------------


def _mesh_cases(mesh, params_np: dict, device) -> dict:
    return {"serve": {name: serve_case(mesh, name, params_np[name], device) for name in NAMES},
            "meta_cells": meta_cells(mesh), "smoke_cells": smoke_cells(mesh, device)}


def world4_rank(rank: int, world: int, device, params_np: dict) -> dict:
    """(data=1, model=4) and (data=2, model=2) on 4 ranks: every config
    served on both meshes, the cells, and the refusals asked on
    ``(2, 2)``."""
    from repro_torch.launch.mesh import make_process_mesh

    meshes = {"1x4": make_process_mesh(model=4), "2x2": make_process_mesh(data=2, model=2)}
    return {"mesh": {k: mesh_info(m) for k, m in meshes.items()},
            "cases": {k: _mesh_cases(m, params_np, device) for k, m in meshes.items()},
            "refusals": cell_refusals(meshes)}


def world2_rank(rank: int, world: int, device, params_np: dict) -> dict:
    """(data=1, model=2) on 2 ranks: every config served, the cells, and
    the refusals."""
    from repro_torch.launch.mesh import make_process_mesh

    mesh = make_process_mesh(model=2)
    return {"mesh": {"1x2": mesh_info(mesh)}, "cases": {"1x2": _mesh_cases(mesh, params_np,
                                                                           device)},
            "refusals": cell_refusals({"1x2": mesh})}
