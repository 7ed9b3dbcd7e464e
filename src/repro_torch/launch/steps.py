"""Step factories: train, prefill, serve and slot prefill — the port of
``repro.launch.steps``.

PyTorch runs eagerly, so a "step" is a plain closure over the config;
there is no compile cache to key.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.shapes import SHAPES
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import hints
from repro_torch.parallel.sharding import batch_pspecs
from repro_torch.parallel.collectives import (
    dp_size_of,
    split_batch,
    torrent_grad_reduce,
    torrent_joint_grad_reduce,
)
from repro_torch.runtime.spans import maybe_span
from repro_torch.tree import leaves, map_tree, unflatten


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
    along each batch leaf's batch axis, which ``cfg`` decides
    (``parallel.sharding.batch_pspecs``: axis 1 of M-RoPE ``positions``
    (3, B, S), axis 0 of every other leaf), as JAX's cells pass
    ``batch_specs``. ``error_feedback`` (needs ``compress_grads``)
    changes the signature to ``(params, opt_state, ef_state, batch) ->
    (params, opt_state, ef_state, metrics)``. ``microbatches > 1``
    accumulates grads over M slices of the batch (a loop where JAX
    scans; mean of the microbatch means, as JAX computes it). The step
    updates params and optimizer state in place, as the JAX step donates
    them, and returns the same tensors. With one rank there is no
    exchange, and MoE layers take the flat path. ``spans`` (a
    :class:`~repro_torch.runtime.spans.Spans`) records ``fwd_bwd`` per
    rank (one for the joint forward), ``reduce`` and ``optimizer`` spans
    of every step.
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
    # the axes depend on the shape's kind only
    batch_specs = batch_pspecs(cfg, SHAPES["train_4k"])

    grad_fn_local = make_grad_fn(cfg, remat=remat, loss_chunks=loss_chunks)
    grad_fn_mean = (make_mean_grad_fn(cfg, mesh, remat=remat, loss_chunks=loss_chunks)
                    if joint else None)

    def grad_fn_xla(params, batch):
        """Plain mean of the ranks' grads (the fabric's all-reduce)."""
        if joint:
            with maybe_span(spans, "fwd_bwd", leaves(params)[0].device):
                return grad_fn_mean(params, batch)
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

    def optimizer(grads, opt_state, params):
        with maybe_span(spans, "optimizer", leaves(params)[0].device):
            return adamw.update(opt_cfg, grads, opt_state, params)

    if joint:
        reducer = functools.partial(
            torrent_joint_grad_reduce,
            make_joint_grad_fn(cfg, mesh, remat=remat, loss_chunks=loss_chunks))
    else:
        reducer = functools.partial(torrent_grad_reduce, grad_fn_local,
                                    batch_specs=batch_specs)

    if collectives == "torrent":
        grad_fn = reducer(mesh, **reduce_kw)
    else:
        grad_fn = grad_fn_xla

    if error_feedback:
        reduce_ef = reducer(mesh, error_feedback=True, **reduce_kw)

        def train_step_ef(params, opt_state, ef_state, batch):
            grads, metrics, new_ef = reduce_ef(params, batch, ef_state)
            new_params, new_opt, om = optimizer(grads, opt_state, params)
            return new_params, new_opt, new_ef, {**metrics, **om}

        return train_step_ef

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            M = microbatches
            acc, ms = None, []
            for m in range(M):
                grads, metrics = grad_fn(params, split_batch(batch, M, m, batch_specs))
                grads = map_tree(lambda g: g.to(torch.float32), grads)
                acc = grads if acc is None else map_tree(torch.add, acc, grads)
                ms.append(metrics)
            grads = map_tree(lambda g: g / M, acc)
            metrics = map_tree(lambda *xs: torch.stack(xs).mean(0), *ms)
        else:
            grads, metrics = grad_fn(params, batch)
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
    row into the live batch cache with :func:`write_cache_slot`."""

    def slot_prefill_step(params, tokens):
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
