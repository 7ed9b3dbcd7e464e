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
* optimizer state: params' spec + extra ``data`` sharding (ZeRO-1);
* decode caches: batch over ``(pod, data)``, heads over ``model``; the
  ``long_500k`` cells instead shard KV slots over ``data`` (SP).

One card runs the DP ranks as rows of a stacked view, so what a batch
leaf's spec says to the split (``collectives.split_batch``) is which
axis holds the batch: :func:`batch_axis`.
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.shapes import Shape
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.spec import P
from repro_torch.tree import map_with_path

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


def opt_pspecs(param_specs: PyTree, params: PyTree, data_size: int) -> dict:
    from repro_torch.optim.adamw import zero1_specs

    return zero1_specs(param_specs, params, data_size)


__all__ = ["BATCH_AXES", "batch_axis", "batch_pspecs", "cache_pspecs", "opt_pspecs",
           "param_pspecs"]
