"""Step factories (train, prefill, serve and slot prefill) and the cell
builder — the port of ``repro.launch.steps``.

PyTorch runs eagerly, so a "step" is a plain closure over the config;
there is no compile cache to key. :func:`build_cell` is the one entry
that a dry run, a trainer and a benchmark share: given (arch, shape,
mesh) it returns the step function, its arguments (meta tensors by
default, as JAX's ``ShapeDtypeStruct``s: nothing allocated) and the
partition specs of its inputs and outputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES, Shape, input_specs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import hints
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tp as tp_mod
from repro_torch.parallel.spec import P, keep_axes
from repro_torch.parallel.collectives import (
    _rank_mean,
    dp_size_of,
    split_batch,
    torrent_grad_reduce,
    torrent_joint_grad_reduce,
)
from repro_torch.runtime.spans import maybe_span
from repro_torch.tree import leaves, map_tree, map_with_path, unflatten

PyTree = Any


def make_grad_fn(cfg: ModelConfig, *, remat: str = "dots", loss_chunks: int = 8):
    """``grad_fn(params, batch) -> (grads, metrics)``: the grads of
    :func:`~repro_torch.models.transformer.loss_fn` on ``batch`` (one
    rank's rows) with respect to every param leaf, by autograd; a leaf
    the loss does not read (the token table under a batch of ``embeds``)
    gets zeros, as under ``jax.grad``."""

    def grad_fn(params, batch):
        ps = map_tree(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = T.loss_fn(ps, cfg, batch, remat=remat, loss_chunks=loss_chunks)
            grads = torch.autograd.grad(loss, leaves(ps), materialize_grads=True)
        return unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_joint_grad_fn(cfg: ModelConfig, mesh, *, remat: str = "dots", loss_chunks: int = 8):
    """``grad_fn(params, batch, out=None) -> (stacked, metrics)``: the
    grads of every DP rank of ``mesh`` from ONE forward and backward
    (:func:`~repro_torch.models.transformer.loss_fn_ranks`, under
    ``parallel.hints.set_mesh(mesh)``, so each MoE layer exchanges tokens
    across the ranks by ``moe_apply_ep``), for expert parallelism inside
    the train step.

    Each param gets one leaf per rank (``detach().requires_grad_()``:
    they share the param's storage, so they cost no memory); rank ``r``'s
    rows read leaf ``r``, and so do the experts rank ``r`` owns. The
    backward of the sum of the ranks' losses accumulates into the leaves'
    ``.grad``, which are the rows of one preallocated ``(dp, *shape)``
    buffer per param (``out``, reused when its shapes match): rank ``r``'s
    grads are what JAX's ``shard_map`` rank ``r`` computes — its own loss
    through its own rows, plus the terms that reach it back through the
    all-to-alls and the averaged aux statistics. Metrics are averaged
    over the ranks."""
    n = dp_size_of(mesh)

    def grad_fn(params, batch, out=None):
        p_leaves = leaves(params)
        if out is None or [(tuple(o.shape), o.dtype, o.device) for o in out] != [
            ((n,) + tuple(p.shape), p.dtype, p.device) for p in p_leaves
        ]:
            out = [p.new_zeros((n,) + tuple(p.shape)) for p in p_leaves]
        else:
            for o in out:
                o.zero_()
        ranks = [map_tree(lambda p: p.detach().requires_grad_(True), params) for _ in range(n)]
        for r, rp in enumerate(ranks):
            for leaf, o in zip(leaves(rp), out):
                leaf.grad = o[r]  # backward accumulates into the row in place
        with torch.enable_grad(), hints.set_mesh(mesh):
            losses, metrics = T.loss_fn_ranks(ranks, cfg, batch, remat=remat,
                                              loss_chunks=loss_chunks)
            torch.autograd.backward(losses.sum(), inputs=[x for rp in ranks for x in leaves(rp)])
        return out, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_mean_grad_fn(cfg: ModelConfig, mesh, *, remat: str = "dots", loss_chunks: int = 8):
    """``grad_fn(params, batch) -> (grads, metrics)``: the grads of the
    mean of the DP ranks' losses (``loss_fn_ranks``, every rank reading
    the same leaves, under ``set_mesh(mesh)``) — the global-batch loss
    and its grads that JAX's ``collectives="xla"`` step takes with
    expert parallelism."""
    n = dp_size_of(mesh)

    def grad_fn(params, batch):
        ps = map_tree(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad(), hints.set_mesh(mesh):
            losses, metrics = T.loss_fn_ranks([ps] * n, cfg, batch, remat=remat,
                                              loss_chunks=loss_chunks)
            grads = torch.autograd.grad(losses.mean(), leaves(ps))
        return unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def _ep_joint(cfg: ModelConfig, dp_size: int) -> bool:
    """Whether the step runs its ranks in one forward: expert
    parallelism over more than one rank, on a model whose experts the
    ranks divide. (Otherwise each rank's MoE layers take the flat path
    on its own tokens, as JAX's manual-axis route falls back.)"""
    return bool(cfg.moe_ep_dispatch and dp_size > 1 and cfg.num_experts
                and cfg.num_experts % dp_size == 0)


def _mean_over(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """``g`` summed over ``group`` by the backend's all-reduce, in place
    (gloo stages a CUDA tensor through pinned host memory itself), and
    divided by ``n``; a tensor divisor keeps the divide a true division
    on CUDA."""
    dist.all_reduce(g, group=group)
    return g.div_(torch.tensor(float(n), dtype=g.dtype, device=g.device))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.OptConfig,
    *,
    remat: str = "dots",
    collectives: str = "xla",
    num_chains: int | str = 1,
    ar_algo: str = "rs_ag",
    compress_grads: bool = False,
    error_feedback: bool = False,
    bucket_bytes: int | None = None,
    topology: str | None = None,
    mesh=None,
    batch_specs=None,
    loss_chunks: int = 8,
    microbatches: int = 1,
    spans=None,
):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``mesh`` is a :class:`~repro_torch.launch.mesh.VirtualMesh`; its DP
    ranks run one after another on the card, each on its rows of the
    global batch — or, with ``cfg.moe_ep_dispatch`` over more than one
    rank and experts the ranks divide, all at once in one forward whose
    MoE layers exchange tokens across the ranks with chain all-to-alls
    (:func:`make_joint_grad_fn`; ``"xla"``: :func:`make_mean_grad_fn`).
    ``collectives="torrent"`` reduces their grads with
    :func:`~repro_torch.parallel.collectives.torrent_grad_reduce`
    (``num_chains``, ``ar_algo``, ``compress_grads`` = int8 wire,
    ``bucket_bytes``, ``topology``); ``"xla"`` takes the plain mean of
    the ranks' grads. The ranks' rows and the microbatches are split
    along each batch leaf's batch axis, the dim its spec in
    ``batch_specs`` splits over the batch axes, as JAX's cells pass
    them; by default ``cfg``'s (``parallel.sharding.batch_pspecs``: axis
    1 of M-RoPE ``positions`` (3, B, S), axis 0 of every other leaf).
    ``error_feedback`` (needs ``compress_grads``) changes the signature to ``(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, metrics)``. ``microbatches > 1``
    accumulates grads over M slices of the batch (a loop where JAX
    scans; mean of the microbatch means, as JAX computes it). The step
    updates params and optimizer state in place, as the JAX step donates
    them, and returns the same tensors. With one rank there is no
    exchange, and MoE layers take the flat path. ``spans`` (a
    :class:`~repro_torch.runtime.spans.Spans`) records ``fwd_bwd`` per
    rank (one for the joint forward), ``reduce`` and ``optimizer`` spans
    of every step, and on a TP mesh a ``tp_comm`` span per collective of
    the model group.

    On a :class:`~repro_torch.launch.mesh.ProcessMesh` the step is one
    rank's, as a JAX ``shard_map`` device's: ``batch`` is this rank's
    rows, its grads are reduced over the mesh's process groups by the
    Torrent reduction (``ef_state`` is this rank's ``(1, *shape)`` rows;
    each leaf's mean is written into the rank's own grad buffer), AdamW
    runs on this rank's copy (its ZeRO-1 blocks where ``data`` is live,
    below), and ``microbatches > 1`` accumulates
    the rank's microbatch grads locally before the one reduction (the
    stacked step reduces each microbatch). With ``cfg.moe_ep_dispatch``
    (experts the ranks divide) each rank's MoE layers exchange its tokens
    with the other ranks' over the mesh's DP group, and its backward
    gives it the grads JAX's ``shard_map`` rank gets.
    ``collectives="xla"`` sums the rank's grads over the DP group with
    the backend's all-reduce and divides by the DP size (JAX's xla step:
    the mean the fabric gives; the stacked step's mean up to the f32
    rounding of the sum's order). Where the ``data`` axis is live the
    optimizer is ZeRO-1's (``adamw.update_zero1``): ``opt_state``'s
    moments are this rank's blocks by ``opt_pspecs``
    (``parallel.sharding.train_state_specs``; ``adamw.init(params,
    specs=, mesh=)`` builds them), the rank updates its block of each
    param and all-gathers the blocks over ``data`` (a ``param_gather``
    span inside ``optimizer``).

    With a ``model`` axis > 1 (a ``ProcessMesh`` only) the params, the
    optimizer state (split over a live ``data`` axis as well, above),
    the grads and the EF residual are this rank's shards
    (``parallel.sharding.param_pspecs`` placed by ``shard_tree``): the
    forward and backward run Megatron's
    collectives over the model group (``parallel.tp``; the remat'd
    recompute runs them again, in the same order on every TP rank), the
    Torrent reduction runs over the DP group on the shards, and AdamW
    clips by the logical tree's norm. Microbatching is unchanged. The
    TP form covers every family (``transformer.check_tp`` refuses heads
    the TP size does not divide without ``attn_seq_shard``).

    A flat-dispatch MoE layer takes its capacity, positions and aux loss
    from the global batch in the ``collectives="xla"`` step (JAX's GSPMD
    step), and from the rank's own tokens in the Torrent step, as JAX's
    ``shard_map`` rank does: on a ``ProcessMesh`` the Torrent step's
    grad function runs with the DP axes Manual (``hints.manual_axes``);
    the stacked view's xla step (a ``VirtualMesh``) takes a flat MoE
    model's grads as one function of the whole batch.
    """
    if compress_grads and collectives != "torrent":
        raise ValueError(
            'compress_grads=True requires collectives="torrent" '
            "(the int8 wire is a property of the Chainwrite schedule; "
            "the XLA backend has no compressed all-reduce)"
        )
    if error_feedback and not compress_grads:
        raise ValueError(
            "error_feedback=True requires compress_grads=True: with an "
            "exact wire there is no quantization residual to feed back"
        )
    if error_feedback and microbatches > 1:
        raise ValueError(
            "error_feedback with microbatches > 1 is not supported: the "
            "residual is per wire reduction, not per accumulation step"
        )
    if bucket_bytes is not None and collectives != "torrent":
        raise ValueError(
            'bucket_bytes requires collectives="torrent" (bucketed '
            "dispatch is a property of the Chainwrite reduction; the "
            "XLA backend buckets internally)"
        )
    if topology is not None and collectives != "torrent":
        raise ValueError(
            'topology requires collectives="torrent" (the link-graph '
            "spec steers the Chainwrite ring planner; the XLA backend "
            "has no topology knob)"
        )
    if collectives not in ("xla", "torrent"):
        raise ValueError(f"unknown collectives {collectives!r}")
    if mesh is None:
        mesh = make_host_mesh()
    wire_dtype = "int8" if compress_grads else None
    dp_size = dp_size_of(mesh)
    joint = _ep_joint(cfg, dp_size)
    dp_group = mesh.group(hints.dp_axes(mesh.axis_names))
    process = dp_group is not None
    if batch_specs is None:  # the specs depend on the shape's kind only
        batch_specs = shd.batch_pspecs(cfg, SHAPES["train_4k"])

    tp = mesh.shape.get("model", 1)
    grad_fn_local = make_grad_fn(cfg, remat=remat, loss_chunks=loss_chunks)
    if tp > 1 or process:
        grad_fn_rank = grad_fn_local

        def grad_fn_local(params, batch):
            """This rank's grads of its shards and rows: the model code
            finds the TP group, the expert-parallel group and the global
            batch's DP group on the mesh (the remat'd recompute runs
            inside it too); each TP collective is a ``tp_comm`` span."""
            with hints.set_mesh(mesh), tp_mod.timed(spans):
                return grad_fn_rank(params, batch)
    if process:
        grad_fn_global = grad_fn_local

        def grad_fn_shard_map(params, batch):
            """This rank's grads as a JAX ``shard_map`` rank computes
            them, the DP axes Manual: a MoE layer's capacity from the
            rank's own tokens (the Torrent reduce's ranks)."""
            with hints.manual_axes(hints.dp_axes(mesh.axis_names)):
                return grad_fn_global(params, batch)
    grad_fn_mean = (make_mean_grad_fn(cfg, mesh, remat=remat, loss_chunks=loss_chunks)
                    if joint and not process else None)

    def grad_fn_xla_process(params, batch):
        """This rank's grads (its microbatches accumulated first), summed
        over the DP group by the backend's all-reduce and divided by the
        DP size: the plain mean JAX's xla step takes from the fabric."""
        device = leaves(params)[0].device
        with maybe_span(spans, "fwd_bwd", device):
            grads, metrics = accumulated(grad_fn_local)(params, batch)
        with maybe_span(spans, "reduce", device):
            grads = map_tree(lambda g: _mean_over(g, dp_group, dp_size), grads)
        return grads, _rank_mean(metrics, dp_group, dp_size)

    def grad_fn_xla(params, batch):
        """Plain mean of the ranks' grads (the fabric's all-reduce). A
        dense model's ranks run one at a time: each rank's partial grads
        summed is what the GSPMD step and the process form's xla step
        (:func:`grad_fn_xla_process`) compute, which the stacked step
        meets bit for bit on two ranks (``tests/test_torch_tp.py``
        ``test_xla_process_step_matches_the_stacked_xla_step``), and one
        rank's activations are live at a time. A flat MoE's capacity and
        aux loss couple the ranks' tokens, so its model's grads are one
        call on the whole batch, as JAX's xla step takes them."""
        if joint or cfg.num_experts:
            with maybe_span(spans, "fwd_bwd", leaves(params)[0].device):
                return (grad_fn_mean if joint else grad_fn_local)(params, batch)
        acc, msum = None, None
        for r in range(dp_size):
            with maybe_span(spans, "fwd_bwd", leaves(params)[0].device):
                grads, metrics = grad_fn_local(params,
                                               split_batch(batch, dp_size, r, batch_specs))
            acc = grads if acc is None else map_tree(torch.add, acc, grads)
            msum = metrics if msum is None else map_tree(torch.add, msum, metrics)
        return (map_tree(lambda g: g / dp_size, acc),
                map_tree(lambda m: m / dp_size, msum))

    reduce_kw = dict(num_chains=num_chains, algo=ar_algo, wire_dtype=wire_dtype,
                     bucket_bytes=bucket_bytes, topology=topology, spans=spans)

    # under TP, the clipping norm is the logical tree's: AdamW sums the
    # split leaves' squares over the model group
    norm_kw = {}
    if tp > 1:
        norm_kw = dict(group=mesh.group("model"), split=map_tree(
            lambda s: shd.is_split(s, mesh), shd.logical_pspecs(cfg, tp)))

    # ZeRO-1 where the process form's data axis is live: each rank holds
    # its block of the moments (opt_pspecs), updates its block of each
    # param and all-gathers the blocks over data, as JAX's GSPMD step does
    if process and mesh.shape.get("data", 1) > 1:
        mu_specs = shd.train_state_specs(cfg, mesh)["opt"]["mu"]

        def update(grads, opt_state, params):
            return adamw.update_zero1(opt_cfg, grads, opt_state, params, specs=mu_specs,
                                      mesh=mesh, spans=spans, **norm_kw)
    else:
        def update(grads, opt_state, params):
            return adamw.update(opt_cfg, grads, opt_state, params, **norm_kw)

    def optimizer(grads, opt_state, params):
        with maybe_span(spans, "optimizer", leaves(params)[0].device):
            return update(grads, opt_state, params)

    def accumulated(fn):
        """``fn``'s grads accumulated over ``microbatches`` slices of the
        batch (mean of the microbatch means, as JAX computes it)."""
        if microbatches == 1:
            return fn

        def fn_acc(params, batch):
            acc, ms = None, []
            for m in range(microbatches):
                grads, metrics = fn(params, split_batch(batch, microbatches, m, batch_specs))
                grads = map_tree(lambda g: g.to(torch.float32), grads)
                acc = grads if acc is None else map_tree(torch.add, acc, grads)
                ms.append(metrics)
            return (map_tree(lambda g: g / microbatches, acc),
                    map_tree(lambda *xs: torch.stack(xs).mean(0), *ms))

        return fn_acc

    if joint and not process:
        reducer = functools.partial(
            torrent_joint_grad_reduce,
            make_joint_grad_fn(cfg, mesh, remat=remat, loss_chunks=loss_chunks))
    elif process:  # this rank's microbatches accumulate before the one reduction
        reducer = functools.partial(torrent_grad_reduce, accumulated(grad_fn_shard_map))
    else:
        reducer = functools.partial(torrent_grad_reduce, grad_fn_local,
                                    batch_specs=batch_specs)

    if collectives == "torrent":
        grad_fn = reducer(mesh, **reduce_kw)
    elif process:
        grad_fn = grad_fn_xla_process
    else:
        grad_fn = grad_fn_xla

    if error_feedback:
        reduce_ef = reducer(mesh, error_feedback=True, **reduce_kw)

        def train_step_ef(params, opt_state, ef_state, batch):
            grads, metrics, new_ef = reduce_ef(params, batch, ef_state)
            new_params, new_opt, om = optimizer(grads, opt_state, params)
            return new_params, new_opt, new_ef, {**metrics, **om}

        return train_step_ef

    # the stacked step reduces each microbatch; the process form's grad_fn
    # has accumulated them already
    grad_fn_step = grad_fn if process else accumulated(grad_fn)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_fn_step(params, batch)
        new_params, new_opt, om = optimizer(grads, opt_state, params)
        return new_params, new_opt, {**metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """``prefill_step(params, batch) -> (last-token logits (B, V),
    cache)``: the whole batch's prompts (tokens, or embeds and M-RoPE
    positions, plus encoder frames where the model has an encoder) at
    once."""

    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, max_seq)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, tokens, pos, cache):
        logits, new_cache = T.decode_step(params, cfg, tokens, pos, cache)
        next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tokens, new_cache

    return serve_step


def make_slot_prefill_step(cfg: ModelConfig, max_seq: int):
    """Per-slot prefill for continuous batching: one (1, S) prompt in,
    (first greedy token (1,), single-row cache) out. It never touches
    the other slots' state — the serve loop writes the returned cache
    row into the live batch cache with :func:`write_cache_slot`. On a
    ``ProcessMesh`` each DP rank admits its own prompt, so the step runs
    with the DP axes Manual (``hints.manual_axes``): the prompt is its
    own batch, as JAX's slot prefill is a function of that one prompt (a
    flat MoE's capacity ``capacity(S)``, no exchange with other ranks)."""

    def slot_prefill_step(params, tokens):
        mesh = hints.concrete_mesh()
        manual = hints.dp_axes(mesh.axis_names) if mesh is not None else ()
        with hints.manual_axes(manual):
            logits, cache = T.prefill(params, cfg, {"tokens": tokens}, max_seq)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return slot_prefill_step


def write_cache_slot(cache, one_cache, slot: int):
    """Write a batch=1 cache (from ``make_slot_prefill_step``) into row
    ``slot`` of a live multi-slot cache, in place; returns ``cache``.
    Leaves are (reps, B, ...). An encoder-decoder's ``enc`` leaf is
    (B, T, d) with no ``reps`` axis, so it is refused: writing it as a
    stacked leaf would index its frame axis (the JAX function does so,
    and no JAX path calls it with one)."""
    if "enc" in cache:
        raise ValueError("write_cache_slot: an encoder-decoder cache's 'enc' leaf has no "
                         "reps axis")

    def put(full, one):
        full[:, slot] = one[:, 0].to(full.dtype)

    map_tree(put, cache, one_cache)
    return cache


# ---------------------------------------------------------------------------
# Cell assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One (arch × shape × mesh) cell: JAX's ``Cell`` with the partition
    specs of the step's inputs and outputs (``in_specs``/``out_specs``)
    where JAX holds ``NamedSharding``s, and no ``lower()`` (XLA's)."""

    cfg: ModelConfig
    shape: Shape
    mesh: Any
    step_fn: Callable
    args: tuple  # meta tensors (or concrete ones)
    in_specs: tuple
    out_specs: Any
    donate_argnums: tuple[int, ...] = ()
    num_chains: int | str = 1  # effective K after VARIANTS resolution ("auto" = model-picked)
    ar_algo: str = "rs_ag"  # multi-ring all-reduce schedule (rs_ag | rotation)
    compress_grads: bool = False  # int8 wire on the DP grad reduction
    bucket_bytes: int | None = None  # bucketed backward-overlapped reduce
    topology: str | None = None  # tiered link-graph spec for auto-K planning


def _sanitize(spec: P | None, mesh) -> P:
    """Drop axes the mesh doesn't have (e.g. 'pod' on single-pod)."""
    return P() if spec is None else keep_axes(spec, mesh.axis_names)


def _sanitized(mesh, specs):
    return map_tree(lambda s: _sanitize(s, mesh), specs)


# Named optimization bundles, entry for entry the JAX package's.
# "baseline" is the paper-faithful configuration; each variant is one
# recorded change. Entries are ModelConfig field overrides, except the
# step-builder knobs "num_chains", "ar_algo", "compress_grads",
# "bucket_bytes" and "topology" (popped by build_cell and routed to
# make_train_step).
VARIANTS: dict[str, dict] = {
    "baseline": {},
    # multi-chain Chainwrite DP reduction (K=2 concurrent sub-rings,
    # fused RS+AG schedule); only meaningful with collectives="torrent".
    "k2": {"num_chains": 2},
    # K=2 with the full-payload rotation schedule.
    "k2-rot": {"num_chains": 2, "ar_algo": "rotation"},
    # model-driven K: all_reduce_latency picks per gradient leaf.
    "k-auto": {"num_chains": "auto"},
    # chunked online-softmax attention (flash twin).
    "chunked": {"attn_impl": "chunked"},
    # + absorbed MLA decode + bf16 MoE wire + bf16 norms + row-wise
    # MoE dispatch.
    "opt": {
        "attn_impl": "chunked", "mla_absorb": True,
        "moe_bf16_wire": True, "bf16_norm": True, "moe_row_dispatch": True,
    },
    # Torrent expert-parallel MoE (chain all-to-all dispatch/combine).
    "moe-ep": {"moe_ep_dispatch": True},
    # moe-ep with the K=2 multi-chain all-to-all exchange.
    "moe-ep-k2": {"moe_ep_dispatch": True, "moe_ep_chains": 2},
    # int8-compressed DP gradient reduction; collectives="torrent" only.
    "int8-ar": {"compress_grads": True},
    # int8 wire on the K=2 multi-chain schedule.
    "int8-ar-k2": {"compress_grads": True, "num_chains": 2},
    # Torrent EP MoE with int8-quantized token dispatch/return.
    "moe-ep-int8": {"moe_ep_dispatch": True, "moe_ep_int8_wire": True},
    # bucketed, backward-overlapped DP grad reduce: 4 MiB dtype-grouped
    # buckets in reverse-topological order, model-picked K per bucket.
    "bucketed": {"bucket_bytes": 4 << 20, "num_chains": "auto"},
    # bucketed dispatch with the int8 wire.
    "bucketed-int8": {
        "bucket_bytes": 4 << 20, "num_chains": "auto",
        "compress_grads": True,
    },
    # tiered link-graph planning: 2 pods with 4x slower inter-pod links
    # for num_chains="auto"; degrades to the uniform ring where 2 does
    # not divide the DP axis.
    "tiered": {
        "topology": "pods=2:interpod_bw=0.25", "num_chains": "auto",
    },
    # opt + query-sequence-sharded attention (heads ∤ TP archs).
    "opt-seq": {
        "attn_impl": "chunked", "mla_absorb": True,
        "moe_bf16_wire": True, "bf16_norm": True, "moe_row_dispatch": True,
        "attn_seq_shard": True,
    },
}

# build_cell's step-builder knobs, in the order JAX's resolves them:
# (name, the value that never conflicts, whether its message quotes it)
_STEP_KNOBS = (("num_chains", 1, False), ("ar_algo", "rs_ag", True),
               ("compress_grads", False, False), ("bucket_bytes", None, False),
               ("topology", None, True))


def _concrete(specs: PyTree, vocab: int, device: torch.device, seed: int) -> PyTree:
    """Tensors on ``device`` with the shapes and dtypes of the meta
    ``specs`` (a batch, or decode tokens): integer leaves uniform in
    [0, vocab) (M-RoPE ``positions``: text positions 0..S-1 on all
    three streams), float leaves standard normal, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(path, x):
        shape = tuple(x.shape)
        if path and path[-1] == "positions":
            return torch.arange(shape[-1], dtype=x.dtype, device=device).expand(shape).contiguous()
        if x.dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device=device).to(x.dtype)
        return torch.randint(0, vocab, shape, generator=gen, device=device, dtype=x.dtype)

    return map_with_path(one, specs)


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    *,
    collectives: str = "xla",
    num_chains: int | str = 1,
    ar_algo: str = "rs_ag",
    compress_grads: bool = False,
    bucket_bytes: int | None = None,
    topology: str | None = None,
    remat: str = "dots",
    smoke: bool = False,
    variant: str = "baseline",
    device="meta",
    cfg_overrides: dict | None = None,
) -> Cell:
    """The cell of ``arch`` at ``C.SHAPES[shape_name]`` on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.VirtualMesh` or a
    :class:`~repro_torch.launch.mesh.ProcessMesh`), with
    ``variant``'s overrides: ``VARIANTS`` resolves as in JAX, and a
    step-builder knob passed explicitly against the variant's raises
    ``ValueError``.

    On ``device="meta"`` the args are meta tensors (``model_init`` and
    ``adamw.init`` on the meta device, ``configs.shapes.input_specs``):
    nothing is allocated. On a real device the params are
    ``model_init``'s from a generator seeded 0, the optimizer state
    ``adamw.init``'s, a batch or the decode tokens come from a generator
    seeded 1 (:func:`_concrete`), the decode position is 0 and its cache
    ``init_cache``'s. ``remat`` reaches the train step (prefill keeps no
    autograd state, so the port's takes none).

    On a mesh whose DP axes have a process group (a ``ProcessMesh``,
    one rank per process) the cell is one rank's, as a device's view of
    JAX's cell: its step runs under ``hints.set_mesh(mesh)``, and its
    args are this rank's blocks of the same draws — the params as
    ``param_pspecs`` place them (``sharding.leaf_placer``, each leaf cut
    as it is drawn), a train cell's AdamW moments as ZeRO-1's
    ``opt_pspecs`` place them (``adamw.init`` at the block shapes: the
    step is ``make_train_step``'s process form, which updates the
    rank's block and all-gathers the params over ``data``), the batch
    rows or decode tokens over ``data`` (``batch_pspecs``), and the
    decode cache by ``cache_pspecs`` (``sharding.place_cache``; on a
    real device the rank's zero block, ``init_cache`` under the mesh);
    meta tensors of those block shapes on the meta device.
    ``in_specs``/``out_specs`` stay JAX's. Train, prefill and decode
    cells build for all ten architectures, ``long_500k`` included: its
    one sequence is replicated on every rank (token spec ``P()``), and
    its cache's slots are split over ``data`` as ``cache_pspecs`` splits
    them, each rank holding the one row and ``slots / data`` slots of
    each ``k``/``v`` (``ckv``/``krope``) leaf; its step runs under
    ``hints.replicated_batch``, a sequence-parallel decode whose softmax
    is combined over ``data`` (``models.attention``), and a MoE layer
    there takes the one token's capacity with no exchange over ``data``.
    A flat-dispatch MoE cell over a live ``data`` axis takes the global
    batch's capacity where JAX's cell is a GSPMD function of it
    (prefill, decode, the xla train step; the ranks exchange their
    per-expert counts), and each rank's own in the Torrent train step,
    whose reduce JAX runs per ``shard_map`` rank (``models.moe``). The
    ``moe-ep*`` variants run expert parallelism over ``data`` under a
    live ``model`` axis too (``moe._moe_apply_ep_auto``). Heads the TP
    size does not divide without ``attn_seq_shard`` raise
    ``NotImplementedError`` (:func:`_refuse_process_cell`; the
    ``opt-seq`` variant sets the flag; whisper-tiny's 6 heads at
    TP = 4). ``cfg_overrides`` are ``ModelConfig`` fields set on top of the
    variant's (the dry run's ``attn_seq_shard`` where the TP size does
    not divide the heads)."""
    cfg = C.get_smoke_config(arch) if smoke else C.get_config(arch)
    overrides = dict(VARIANTS.get(variant) or {})
    knobs = dict(num_chains=num_chains, ar_algo=ar_algo, compress_grads=compress_grads,
                 bucket_bytes=bucket_bytes, topology=topology)
    for name, default, quoted in _STEP_KNOBS:
        pinned = overrides.pop(name, None)
        if pinned is None:
            continue
        if knobs[name] not in (default, pinned):
            fmt = repr if quoted else str
            raise ValueError(
                f"variant {variant!r} sets {name}={fmt(pinned)} but "
                f"{name}={fmt(knobs[name])} was passed explicitly"
            )
        knobs[name] = pinned
    overrides.update(cfg_overrides or {})
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = C.SHAPES[shape_name]
    tp = mesh.shape.get("model", 1)
    dev = resolve_device(device)
    meta = dev.type == "meta"
    # one rank per process where the DP axes have a process group
    process = mesh.group(hints.dp_axes(mesh.axis_names)) is not None
    if process:
        _refuse_process_cell(cfg, shape, mesh)

    gen = torch.Generator(device="cpu" if meta else dev).manual_seed(0)
    logical = shd.logical_params(cfg)
    pspecs = shd.param_pspecs(logical, cfg, tp=tp)
    # on a process mesh each leaf is cut to this rank's block as it is drawn
    params = T.model_init(gen, cfg, device=dev,
                          place=shd.leaf_placer(pspecs, mesh) if process else None)
    with hints.set_mesh(None):  # the logical inputs, whatever mesh the caller set
        specs = input_specs(cfg, shape)

    def rows(spec_batch, spec_tree):
        """A global input (meta, or drawn by :func:`_concrete`); on a
        process mesh this rank's rows of it."""
        whole = spec_batch if meta else _concrete(spec_batch, cfg.vocab_size, dev, 1)
        if not process:
            return whole
        return map_tree(lambda x: x.clone(), shd.shard_tree(whole, spec_tree, mesh))

    # a decode cell of one sequence (long_500k): its token is replicated
    # (spec P()) and its cache's slots are split over data
    replicated = shape.kind == "decode" and shape.global_batch == 1

    def on_mesh(fn: Callable) -> Callable:
        """``fn``, run under ``hints.set_mesh(mesh)`` on a process mesh
        (and ``hints.replicated_batch`` for a replicated decode batch):
        the model code finds its TP group and its slot group there."""
        if not process:
            return fn

        def step(*args):
            with hints.set_mesh(mesh), _replicated(replicated, shape.seq_len):
                return fn(*args)

        return step

    if shape.kind == "train":
        ospecs = shd.opt_pspecs(pspecs, logical, data_size=mesh.shape.get("data", 1))
        # a process rank's ZeRO-1 blocks of the moments (whole on the stacked view)
        opt_state = adamw.init(params, specs=ospecs, mesh=mesh)
        bspecs = shd.batch_pspecs(cfg, shape)
        step = make_train_step(
            cfg, adamw.OptConfig(), remat=remat, collectives=collectives,
            **knobs, mesh=mesh, batch_specs=_sanitized(mesh, bspecs),
        )
        return Cell(
            cfg=cfg, shape=shape, mesh=mesh, step_fn=step,
            args=(params, opt_state, rows(specs["batch"], bspecs)),
            in_specs=(_sanitized(mesh, pspecs), _sanitized(mesh, ospecs),
                      _sanitized(mesh, bspecs)),
            out_specs=(_sanitized(mesh, pspecs), _sanitized(mesh, ospecs), None),
            donate_argnums=(0, 1),
            **knobs,
        )

    if shape.kind == "prefill":
        bspecs = _sanitized(mesh, shd.batch_pspecs(cfg, shape))
        cspecs = shd.logical_cache_pspecs(cfg, shape, shape.global_batch, specs["max_seq"], tp)
        return Cell(
            cfg=cfg, shape=shape, mesh=mesh,
            step_fn=on_mesh(make_prefill_step(cfg, specs["max_seq"])),
            args=(params, rows(specs["batch"], bspecs)),
            in_specs=(_sanitized(mesh, pspecs), bspecs),
            out_specs=(_sanitize(P(shd.BATCH_AXES, None), mesh), _sanitized(mesh, cspecs)),
        )

    # decode; on a process mesh the cache is placed by its specs (the
    # Mamba-2 conv window in the rank's layout, sharding.place_cache)
    cspecs = shd.cache_pspecs(specs["cache"], cfg, shape, tp=tp)
    tok_spec = P() if shape.global_batch == 1 else _sanitize(P(shd.BATCH_AXES), mesh)
    if meta:
        cache = shd.place_cache(specs["cache"], cspecs, cfg, mesh) if process else specs["cache"]
    elif process:  # the rank's zero block: its rows, or every row and its block of the slots
        rows_here = shape.global_batch if replicated else shape.global_batch // dp_size_of(mesh)
        with hints.set_mesh(mesh), _replicated(replicated, shape.seq_len):
            cache = T.init_cache(cfg, rows_here, shape.seq_len, device=dev)
    else:
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
    return Cell(
        cfg=cfg, shape=shape, mesh=mesh, step_fn=on_mesh(make_serve_step(cfg)),
        args=(params, rows(specs["tokens"], tok_spec),
              specs["pos"] if meta else torch.zeros((), dtype=torch.int32, device=dev), cache),
        in_specs=(_sanitized(mesh, pspecs), tok_spec, P(), _sanitized(mesh, cspecs)),
        out_specs=(tok_spec, _sanitized(mesh, cspecs)),
        donate_argnums=(3,),
    )


def _replicated(on: bool, max_seq: int):
    """``hints.replicated_batch(max_seq)`` where ``on``, else a no-op
    block."""
    return hints.replicated_batch(max_seq) if on else contextlib.nullcontext()


def _refuse_process_cell(cfg: ModelConfig, shape: Shape, mesh) -> None:
    """Raise for the cells :func:`build_cell` does not build on a
    ``ProcessMesh``: an attention that ``transformer.check_tp`` refuses
    at the mesh's TP size (heads it does not divide without
    ``attn_seq_shard``), a global batch the DP ranks do not divide
    (``ValueError``), and a one-sequence decode cell (``long_500k``)
    whose cache slots the ``data`` size does not divide (``ValueError``,
    from ``init_cache``'s blocks); such a cell otherwise builds, each
    rank holding the whole batch and its block of the slots."""
    dp = dp_size_of(mesh)
    with hints.set_mesh(mesh):
        T.check_tp(cfg)
    if shape.kind == "decode" and shape.global_batch == 1:
        with hints.set_mesh(mesh), hints.replicated_batch(shape.seq_len):
            T.init_cache(cfg, 1, shape.seq_len, device="meta")  # the slot blocks split
        return
    if shape.global_batch % dp:
        raise ValueError(f"global batch {shape.global_batch} does not split over {dp} DP ranks")
