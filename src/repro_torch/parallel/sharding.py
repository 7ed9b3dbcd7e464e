"""Parameter / batch / cache partition specs (DP + TP/EP + ZeRO-1 + SP) —
the port of ``repro.parallel.sharding``.

The rules are the JAX package's, name-based over the param tree's paths
(built on the ``meta`` device: no allocation) with divisibility checks
against the TP axis size: a dim that does not divide stays replicated.
The specs are pure functions of paths and shapes, so any ``tp`` can be
asked for without a TP mesh. Specs are
:class:`~repro_torch.parallel.spec.PartitionSpec`s, equal entry by
entry to JAX's.

Scheme (Megatron-style):
* embeddings / lm_head: vocab-sharded over ``model``;
* attention: column-parallel QKV (head dim), row-parallel output proj;
* MLA: compress proj replicated, recovery projections column-parallel;
* dense FFN: column-parallel gate/up, row-parallel down;
* MoE: experts sharded over ``model`` (EP);
* mamba2: d_inner (head) dim column-parallel, B/C/dt projections
  replicated;
* optimizer state: params' spec + extra ``data`` sharding (ZeRO-1;
  placed on a process mesh by :func:`state_specs`, updated by
  ``optim.adamw.update_zero1``);
* decode caches: batch over ``(pod, data)``, heads over ``model``; the
  ``long_500k`` cells instead shard KV slots over ``data`` (SP).

One card runs the DP ranks as rows of a stacked view, so what a batch
leaf's spec says to the split (``collectives.split_batch``) is which
axis holds the batch: :func:`batch_axis`.

On a :class:`~repro_torch.launch.mesh.ProcessMesh` the specs place
state: :func:`shard_tree` takes this rank's block of each leaf along
every dim whose spec names a live mesh axis (what JAX's ``device_put``
with a ``NamedSharding`` leaves on a device), and :func:`gather_tree`
puts the blocks back together over the mesh's process groups. A decode
cache is placed by :func:`place_cache` and gathered by
:func:`gather_cache`: ``cache_pspecs``' blocks, but for the Mamba-2
``conv`` window, which a rank holds in the layout its TP form reads.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.spec import P
from repro_torch.parallel.tp import all_gather
from repro_torch.tree import leaves, map_tree, map_with_path, paths, unflatten

PyTree = Any

BATCH_AXES = ("pod", "data")


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _keys(path) -> tuple[str, ...]:
    """A tree path as JAX's rules read it: dict keys and list indices
    as strings."""
    return tuple(str(p) for p in path)


def _param_spec(path: tuple[str, ...], shape: tuple[int, ...], cfg: ModelConfig,
                tp: int) -> P:
    """Spec for one (unstacked) param leaf."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    def col(dim_idx: int) -> P:  # shard output dim over model
        if _div(shape[dim_idx], tp):
            spec = [None] * len(shape)
            spec[dim_idx] = "model"
            return P(*spec)
        return P(*([None] * len(shape)))

    if name == "table":  # embed / lm_head: vocab-sharded
        return P("model", None) if _div(shape[0], tp) else P(None, None)
    if name == "pos_emb":
        return P(*([None] * len(shape)))
    if name in ("wq", "wk", "wv", "gate", "up", "fc1", "in_z", "in_x", "w_uk", "w_uv"):
        return col(1)
    if name in ("bq", "bk", "bv", "b1"):
        return col(0)
    if name in ("wo", "down", "fc2", "out_proj"):
        return col(0)  # row-parallel: shard input (first) dim
    if name in ("wg", "wu", "wd"):  # MoE experts: EP over model
        return P("model", None, None) if _div(shape[0], tp) else P(None, None, None)
    if name in ("conv_x_w",):
        return col(1)
    if name in ("conv_x_b",):
        return col(0)
    if parent == "norm" and len(shape) == 1:  # mamba gated-norm scale (d_inner)
        return col(0)
    # router, w_dkv, in_BC, in_dt, conv_BC_*, dt_bias, A_log, D,
    # norms, biases: replicated
    return P(*([None] * len(shape)))


def param_pspecs(params: PyTree, cfg: ModelConfig, tp: int = 16) -> PyTree:
    """Tree of specs matching ``params`` (``model_init``'s tree; meta
    tensors will do). Leaves under ``groups`` are stacked with a leading
    ``repeat`` dim — their spec gets a ``None`` prefix."""

    def one(path, leaf):
        keys = _keys(path)
        shape = tuple(leaf.shape)
        if "groups" in keys:
            return P(None, *_param_spec(keys, shape[1:], cfg, tp))
        return _param_spec(keys, shape, cfg, tp)

    return map_with_path(one, params)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, shape: Shape) -> dict:
    """The spec of each leaf of a train or prefill batch of ``cfg`` at
    ``shape``: the batch dim over ``BATCH_AXES`` (axis 1 of M-RoPE
    ``positions`` (3, B, S), axis 0 of every other leaf)."""
    out: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            out["embeds"] = P(BATCH_AXES, None, None)
            out["positions"] = P(None, BATCH_AXES, None)
        else:
            out["tokens"] = P(BATCH_AXES, None)
        if cfg.is_encdec:
            out["enc_frames"] = P(BATCH_AXES, None, None)
        if shape.kind == "train":
            out["labels"] = P(BATCH_AXES, None)
        return out
    raise ValueError(shape.kind)


def batch_axis(spec) -> int:
    """The axis of a batch leaf that its spec splits over the DP axes:
    the position of ``BATCH_AXES`` in ``spec``, or of what
    ``launch.steps._sanitize`` kept of them on a mesh (``"data"``)."""
    for i, el in enumerate(spec):
        axes = el if isinstance(el, tuple) else (el,)
        if el is not None and all(a in BATCH_AXES for a in axes):
            return i
    raise ValueError(f"{spec} splits no dim over the batch axes {BATCH_AXES}")


def _cache_leaf_spec(path: tuple[str, ...], shape: tuple[int, ...],
                     cfg: ModelConfig, shape_cfg: Shape, tp: int) -> P:
    """Decode-cache leaf specs. Leaf shapes are stacked: (reps, B, ...)."""
    name = path[-1]
    long_ctx = shape_cfg.global_batch == 1  # long_500k: SP over slots
    batch = None if long_ctx else BATCH_AXES
    if name in ("k", "v"):  # (reps, B, slots, Hkv, Dh)
        heads = "model" if _div(shape[3], tp) else None
        slots = "data" if long_ctx and _div(shape[2], 16) else None
        return P(None, batch, slots, heads, None)
    if name in ("ckv", "krope"):  # (reps, B, slots, r)
        slots = "data" if long_ctx and _div(shape[2], 16) else None
        return P(None, batch, slots, None)
    if name == "conv":  # (reps, B, W-1, conv_dim)
        return P(None, batch, None, "model" if _div(shape[3], tp) else None)
    if name == "ssm":  # (reps, B, H, N, Pdim)
        return P(None, batch, "model" if _div(shape[2], tp) else None, None, None)
    if name == "enc":  # (B, T, d) encoder output (unstacked)
        return P(batch, None, None)
    return P(*([None] * len(shape)))


def cache_pspecs(cache: PyTree, cfg: ModelConfig, shape_cfg: Shape, tp: int = 16) -> PyTree:
    """Tree of specs matching a decode cache (``init_cache``'s tree)."""
    return map_with_path(
        lambda path, leaf: _cache_leaf_spec(_keys(path), tuple(leaf.shape), cfg, shape_cfg, tp),
        cache)


def logical_pspecs(cfg: ModelConfig, tp: int) -> PyTree:
    """:func:`param_pspecs` of ``cfg``'s whole (unsharded) params, from
    ``model_init`` on the meta device: nothing is allocated."""
    return param_pspecs(logical_params(cfg), cfg, tp=tp)


def split_axes(entry, mesh) -> tuple[str, ...]:
    """The live axes of ``mesh`` (size > 1) that one spec entry splits
    its dim over."""
    axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def is_split(spec, mesh) -> bool:
    """Whether ``spec`` splits some dim over the live ``model`` axis of
    ``mesh``."""
    return any("model" in split_axes(e, mesh) for e in spec)


def _block(axes: tuple[str, ...], mesh) -> tuple[int, int]:
    """(index, count) of this rank's block over ``axes``: the linear
    index of its coordinates over them, as ``mesh.group(axes)`` ranks
    its members."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i, math.prod(mesh.shape[a] for a in axes)


def shard_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's block of every leaf of ``tree`` (tensors, or arrays
    with ``shape``): along each dim whose spec in ``specs`` names live
    axes of ``mesh``, block ``i`` of ``n`` equal blocks, ``i`` this
    rank's linear index over those axes (``mesh.coords``). Views, no
    copy. A spec shorter than its leaf leaves the trailing dims whole;
    on a mesh without live axes, or any mesh without ``coords`` (the
    stacked view, which holds every row), the leaf itself."""
    if not hasattr(mesh, "coords"):
        return tree

    def one(x, spec):
        for d, entry in enumerate(spec):
            axes = split_axes(entry, mesh)
            if not axes:
                continue
            i, n = _block(axes, mesh)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not split into {n} "
                                 f"blocks over {axes}")
            size = x.shape[d] // n
            x = x.narrow(d, i * size, size) if isinstance(x, torch.Tensor) else \
                x[(slice(None),) * d + (slice(i * size, (i + 1) * size),)]
        return x

    return unflatten(tree, [one(x, s) for x, s in zip(leaves(tree), leaves(specs))])


def leaf_placer(specs: PyTree, mesh):
    """A ``place(path, x)`` for ``transformer.model_init``: this rank's
    block of each leaf as it is drawn (a copy, so the whole leaf is
    freed), by its spec in ``specs`` (``param_pspecs``' tree); a layer
    of a stacked group leaf by the spec without its ``repeat`` entry."""
    def place(path, x):
        spec = specs
        for key in path:
            spec = spec[key]
        if "groups" in path:
            spec = P(*tuple(spec)[1:])
        y = shard_tree(x, spec, mesh)
        return y if y is x else y.clone()

    return place


def gather_tree(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """The inverse of :func:`shard_tree` on a process mesh: each split
    dim all-gathered over ``mesh.group`` of its axes and concatenated in
    the group's rank order, so every rank gets the whole leaf. The
    identity where nothing is split (and on the stacked view)."""
    if not hasattr(mesh, "coords"):
        return tree

    def one(x, spec):
        for d, entry in enumerate(spec):
            axes = split_axes(entry, mesh)
            if axes:
                x = all_gather(x, mesh.group(axes), d)
        return x

    return unflatten(tree, [one(x, s) for x, s in zip(leaves(tree), leaves(specs))])


def logical_cache_pspecs(cfg: ModelConfig, shape_cfg: Shape, batch: int, max_seq: int,
                         tp: int) -> PyTree:
    """:func:`cache_pspecs` of ``cfg``'s whole decode cache of ``batch``
    rows and ``max_seq`` positions (``init_cache`` on the meta device
    with no mesh active, so the leaves are the logical ones)."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints

    with hints.set_mesh(None):
        cache = T.init_cache(cfg, batch, max_seq, device="meta")
    return cache_pspecs(cache, cfg, shape_cfg, tp=tp)


def _mamba_tp(cfg: ModelConfig, mesh) -> int:
    """The TP size over which a Mamba-2 layer of ``cfg`` splits
    ``d_inner`` on ``mesh`` (1 where it runs whole, as ``param_pspecs``
    leaves a ``d_inner`` the TP size does not divide)."""
    tp = mesh.shape.get("model", 1)
    return tp if tp > 1 and cfg.d_inner % tp == 0 else 1


def place_cache(cache: PyTree, specs: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """This rank's block of every leaf of the logical decode cache
    ``cache`` (copies, so the whole leaves can be freed; meta tensors
    will do), by ``specs`` (:func:`cache_pspecs` of the logical cache):
    the batch over the DP axes, ``k``/``v`` by KV heads where the TP
    size divides them, ``ssm`` by heads, ``ckv``/``krope`` whole; at
    global batch 1 (``long_500k``) the batch whole and the slots of
    ``k``/``v`` and ``ckv``/``krope`` over ``data`` instead, each rank
    its block of ``slots / data`` (a ``data`` size that does not divide
    them raises ``ValueError``).

    One leaf departs from its spec. ``conv`` (reps, B, W-1, conv_dim)
    is the window of the raw ``[x, B, C]`` projections, and
    ``cache_pspecs`` splits its last dim evenly over ``model`` (JAX's
    GSPMD may cut it anywhere). A rank of the port's Mamba-2 TP form
    holds its block of ``x`` (``d_inner / tp`` columns) and the whole
    B and C, so its window is ``[its x block, all of B/C]``, which is
    what ``mamba2_decode`` reads and ``mamba2_prefill`` writes: that is
    the block placed here wherever the layer splits ``d_inner``.
    :func:`gather_cache` rebuilds the logical leaf."""
    if not hasattr(mesh, "coords"):
        return cache
    tp = _mamba_tp(cfg, mesh)

    def one(path, x, spec):
        if path[-1] == "conv" and tp > 1:
            x = shard_tree(x, P(*tuple(spec)[:-1]), mesh)  # the batch rows
            d_in, r = cfg.d_inner // tp, mesh.coords["model"]
            return torch.cat([x[..., r * d_in:(r + 1) * d_in], x[..., cfg.d_inner:]], -1)
        return shard_tree(x, spec, mesh).clone()

    return unflatten(cache, [one(p, x, s) for (p, x), s in zip(paths(cache), leaves(specs))])


def gather_cache(cache: PyTree, specs: PyTree, cfg: ModelConfig, mesh) -> PyTree:
    """The inverse of :func:`place_cache`: every rank gets the logical
    leaves, JAX's ``conv`` layout included (the ranks' ``x`` blocks
    all-gathered over the model group, then B/C, which every rank holds
    whole)."""
    if not hasattr(mesh, "coords"):
        return cache
    tp = _mamba_tp(cfg, mesh)

    def one(path, x, spec):
        if path[-1] == "conv" and tp > 1:
            x = gather_tree(x, P(*tuple(spec)[:-1]), mesh)
            d_in = cfg.d_inner // tp
            xs = all_gather(x[..., :d_in], mesh.group("model"), x.dim() - 1)
            return torch.cat([xs, x[..., d_in:]], -1)
        return gather_tree(x, spec, mesh)

    return unflatten(cache, [one(p, x, s) for (p, x), s in zip(paths(cache), leaves(specs))])


def state_specs(pspecs: PyTree, mesh, *, ef: bool = False, params: PyTree | None = None) -> dict:
    """Specs of a train state ``{"params", "opt", ["ef"]}`` whose params
    have specs ``pspecs``. Where ``mesh``'s ``data`` axis is live,
    AdamW's moments take :func:`opt_pspecs` (ZeRO-1: each also split over
    ``data`` along the first unsplit dim that ``data`` divides, which
    needs the logical ``params``' shapes: meta tensors will do); else
    they are split as their params. AdamW's ``step`` stays whole; the
    error-feedback residual (``(dp, *shape)``,
    ``collectives.ef_residual_init``) is split over the DP axes along dim
    0 and as its param after it. On the stacked view ``shard_tree`` is
    the identity, so its moments stay whole whatever the specs say."""
    from repro_torch.parallel.hints import dp_axes

    data = mesh.shape.get("data", 1)
    if data > 1:
        if params is None:
            raise ValueError("ZeRO-1 specs over a live data axis need the logical params' "
                             "shapes: pass params= (meta tensors will do)")
        opt = opt_pspecs(pspecs, params, data)
    else:
        opt = {"mu": pspecs, "nu": pspecs, "step": P()}
    out = {"params": pspecs, "opt": opt}
    if ef:
        dp = dp_axes(mesh.axis_names)
        out["ef"] = map_tree(lambda s: P(dp, *s), pspecs)
    return out


def logical_params(cfg: ModelConfig) -> PyTree:
    """``cfg``'s whole params as meta tensors (``model_init`` on the meta
    device): their shapes, nothing allocated."""
    from repro_torch.models import transformer as T

    return T.model_init(torch.Generator(device="cpu"), cfg, "meta")


def train_state_specs(cfg: ModelConfig, mesh, *, ef: bool = False) -> dict:
    """:func:`state_specs` of ``cfg``'s train state on ``mesh``: the
    params by ``param_pspecs`` at the mesh's TP size, the moments by
    ZeRO-1's ``opt_pspecs`` where ``data`` is live."""
    params = logical_params(cfg)
    pspecs = param_pspecs(params, cfg, tp=mesh.shape.get("model", 1))
    return state_specs(pspecs, mesh, ef=ef, params=params)


def opt_pspecs(param_specs: PyTree, params: PyTree, data_size: int) -> dict:
    from repro_torch.optim.adamw import zero1_specs

    return zero1_specs(param_specs, params, data_size)


__all__ = ["BATCH_AXES", "batch_axis", "batch_pspecs", "cache_pspecs", "gather_cache",
           "gather_tree", "is_split", "leaf_placer", "logical_cache_pspecs", "logical_params",
           "logical_pspecs", "opt_pspecs", "param_pspecs", "place_cache", "shard_tree",
           "split_axes", "state_specs", "train_state_specs"]
