"""End-to-end fault-tolerant training entry point — the port of
``repro.launch.train``.

Composes the port's layers: the Markov data source, the model, AdamW,
a DP mesh, Torrent or plain-mean gradient reduction, async
checkpointing with restart-on-failure, and straggler monitoring.

In one process the DP ranks are rows of the stacked view, run on one
device (a virtual mesh of ``--dp`` ranks):

    python -m repro_torch.launch.train --smoke --steps 20 --dp 4 \
        --collectives torrent --device cpu

Under ``torchrun`` each process is one DP rank (the process form, JAX's
``shard_map`` devices): the mesh spans the world, each rank loads its
own rows of every batch, and the Torrent reduction runs over
``torch.distributed`` (NCCL on cards, gloo with ``--device cpu``):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --steps 20 --collectives torrent --device cpu

There ``--collectives xla`` (the default, as JAX's) reduces the grads
with the backend's own all-reduce instead. With more than one DP rank
each rank holds AdamW's moments as its ZeRO-1 blocks (split over
``data`` as ``parallel.sharding.opt_pspecs`` places them, as JAX's
``Trainer`` does): it updates its block of each param and all-gathers
the params over ``data``.

With ``--tp N`` (process form only) the world is a ``(data, model)``
mesh of ``world / N`` DP ranks by ``N`` TP ranks: each rank holds its
shards of the state as ``parallel.sharding.param_pspecs`` places them
and runs the Megatron-style forward and backward (``parallel.tp``) of
the dense, MoE, MLA, Mamba-2 and hybrid families (experts over
``model``, MLA by heads, Mamba-2 by ``d_inner``); the Torrent reduction
runs over the DP group. A MoE config with ``moe_ep_dispatch`` (handed in
as ``Trainer(model_cfg=)``) runs expert parallelism over the DP group
there too, each model column exchanging its tokens and a rank running
the experts it owns over ``data`` that lie in its ``model`` block
(``models.moe``), in the Torrent and the xla step:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke \
        --steps 20 --collectives torrent --tp 2 --device cpu

``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import MarkovSource, make_device_placer, rank_slice
from repro_torch.device import resolve_device
from repro_torch.launch.dist import init_from_env
from repro_torch.launch.mesh import make_host_mesh, make_process_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.parallel.collectives import dp_size_of, ef_residual_init
from repro_torch.parallel.hints import dp_axes
from repro_torch.parallel.sharding import (
    BATCH_AXES,
    leaf_placer,
    shard_tree,
    train_state_specs,
)
from repro_torch.parallel.spec import P
from repro_torch.runtime.failure import FaultInjector, resilient_loop
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.tree import leaves, map_tree

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "yi-6b"
    smoke: bool = True
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    peak_lr: float = 1e-3
    warmup_steps: int = 20
    collectives: str = "xla"  # "xla" | "torrent"
    num_chains: int | str = 1  # torrent: K sub-rings, or "auto"
    compress_grads: bool = False
    bucket_bytes: int | None = None  # bucketed reduce
    topology: str | None = None  # tiered link-graph spec (torrent auto-K)
    remat: str = "dots"
    loss_chunks: int = 4
    microbatches: int = 1  # gradient accumulation
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_last_k: int = 3
    tp: int = 1
    dp: int = 1  # data-parallel ranks: virtual ones, or the world's processes
    layers: int | None = None  # depth cut: the config's first N layers
    seed: int = 0
    log_every: int = 10
    fail_at: tuple[int, ...] = ()  # fault-injection (tests/demos)


class Trainer:
    """Owns the virtual mesh, the state, the step function and the
    resilient loop.

    ``params`` starts from carried weights (a tree of numpy arrays, e.g.
    the JAX package's params, or of tensors, which are copied: the step
    updates its state in place); by default they are drawn
    from ``torch.Generator(device).manual_seed(tc.seed)``. ``spans`` (a
    :class:`~repro_torch.runtime.spans.Spans`) is handed to the step,
    which then records its phases; the caller reads it. ``model_cfg``
    replaces the ``tc.arch`` / ``tc.smoke`` config lookup (as
    ``Server``'s does), e.g. a MoE config with ``moe_ep_dispatch``, whose
    step then runs the DP ranks in one forward that exchanges tokens
    between them; ``tc.layers`` still cuts its depth.

    When ``torch.distributed`` is initialised the Trainer is one rank of
    the process form: its mesh is a
    :class:`~repro_torch.launch.mesh.ProcessMesh` ``(data, model)`` over
    the world with ``model = tc.tp`` (``tc.dp`` must be 1 or the world
    size over ``tc.tp``), its placer cuts this rank's rows of each batch
    by its DP coordinate (the TP ranks of one group share them), it
    holds its state placed by ``parallel.sharding.train_state_specs``
    (its EF residual is its ``(1, *shape)`` row) and checkpoints through
    rank 0 in the stacked form's format, the logical leaves. With
    ``tc.tp`` > 1 the params are this rank's shards: the whole model is
    drawn from the seed leaf by leaf, each leaf cut to this rank's block
    as it is drawn (``parallel.sharding.leaf_placer``, by
    ``param_pspecs``; carried params are cut by ``shard_tree``), so
    every TP size starts from the same logical params, and the EF
    residual is built on the shards. With more than one DP rank, at any
    TP size, AdamW's moments are this rank's ZeRO-1 blocks of its
    params (``opt_pspecs``, as JAX's ``Trainer`` places them), allocated
    at that size; the step updates the rank's block and all-gathers the
    params over ``data``. ``tc.collectives`` may be ``"torrent"`` or
    ``"xla"`` (JAX's default: the backend's all-reduce)."""

    def __init__(self, tc: TrainConfig, *, device="cuda", params=None, spans=None,
                 model_cfg: ModelConfig | None = None):
        self.tc = tc
        self.device = resolve_device(device)
        if model_cfg is None:
            model_cfg = C.get_smoke_config(tc.arch) if tc.smoke else C.get_config(tc.arch)
        self.cfg = model_cfg
        if tc.layers is not None:
            self.cfg = dataclasses.replace(self.cfg, num_layers=tc.layers)
        self.spans = spans
        self.rows = slice(None)
        if dist.is_initialized():
            world = dist.get_world_size()
            if tc.tp < 1 or world % tc.tp:
                raise ValueError(f"tp={tc.tp} does not divide a world of {world} processes")
            if tc.dp not in (1, world // tc.tp):
                raise ValueError(f"dp={tc.dp} on a world of {world} processes at tp={tc.tp}: "
                                 "the process form runs one DP rank per TP group")
            self.mesh = make_process_mesh(model=tc.tp)
            self.rows = rank_slice(tc.global_batch, world // tc.tp, self.mesh.dp_index)
        else:
            self.mesh = make_host_mesh(data=tc.dp, model=tc.tp)
        # the process group over the DP ranks: None in the stacked form
        self.group = self.mesh.group(dp_axes(self.mesh.axis_names))
        self.opt_cfg = adamw.OptConfig(
            peak_lr=tc.peak_lr,
            warmup_steps=tc.warmup_steps,
            decay_steps=max(tc.steps, tc.warmup_steps + 1),
        )
        self.source = MarkovSource(
            vocab=self.cfg.vocab_size,
            seq_len=tc.seq_len,
            global_batch=tc.global_batch,
            seed=tc.seed + 1,
        )
        self.place = make_device_placer(self.mesh, P(BATCH_AXES, None), device=self.device)
        self.monitor = StepMonitor()
        self._build(params)

    # -- state / step ----------------------------------------------------
    def _build(self, params):
        tc, cfg = self.tc, self.cfg
        # the process form places its state by specs (the stacked view
        # holds every leaf whole): the params by param_pspecs, AdamW's
        # moments by ZeRO-1's opt_pspecs where data is live
        self.specs = (None if self.group is None else
                      train_state_specs(cfg, self.mesh, ef=tc.compress_grads))
        pspecs = None if self.specs is None else self.specs["params"]
        if params is None:  # the whole model's draws; a TP rank keeps its blocks
            gen = torch.Generator(device=self.device).manual_seed(tc.seed)
            params = T.model_init(gen, cfg, self.device, place=None if pspecs is None
                                  else leaf_placer(pspecs, self.mesh))
        elif not isinstance(leaves(params)[0], torch.Tensor):
            params = params_from_numpy(params, self.device, specs=pspecs, mesh=self.mesh)
        else:
            if pspecs is not None:
                params = shard_tree(params, pspecs, self.mesh)
            params = map_tree(lambda t: t.to(self.device, copy=True), params)
        self.state = {"params": params, "opt": adamw.init(
            params, specs=None if self.specs is None else self.specs["opt"], mesh=self.mesh)}
        if tc.compress_grads:
            # the EF residual rides in the state, so it survives
            # checkpoint/restart like the optimizer moments do
            self.state["ef"] = ef_residual_init(params, 1 if self.group is not None
                                                else dp_size_of(self.mesh))
        self.step_fn = make_train_step(
            cfg,
            self.opt_cfg,
            remat=tc.remat,
            collectives=tc.collectives,
            num_chains=tc.num_chains,
            compress_grads=tc.compress_grads,
            error_feedback=tc.compress_grads,
            bucket_bytes=tc.bucket_bytes,
            topology=tc.topology,
            mesh=self.mesh,
            loss_chunks=tc.loss_chunks,
            microbatches=tc.microbatches,
            spans=self.spans,
        )

    def _device_batch(self, step: int) -> dict:
        return self.place(self.source.batch(step))

    # -- run loop ----------------------------------------------------------
    def run(self) -> dict[str, Any]:
        tc = self.tc
        ckpt = CheckpointManager(tc.ckpt_dir, keep_last_k=tc.keep_last_k, group=self.group,
                                 mesh=self.mesh, specs=self.specs)
        injector = FaultInjector(tc.fail_at)
        losses: list[float] = []

        def one_step(state, i):
            injector.maybe_fail(i)
            self.monitor.start_step()
            batch = self._device_batch(i)
            if "ef" in state:
                params, opt, ef, metrics = self.step_fn(
                    state["params"], state["opt"], state["ef"], batch
                )
            else:
                params, opt, metrics = self.step_fn(state["params"], state["opt"], batch)
                ef = None
            loss = float(metrics["loss"])
            ev = self.monitor.end_step(i)
            if ev is not None:
                log.warning(
                    "straggler step %d: %.3fs (median %.3fs)",
                    ev.step, ev.duration_s, ev.median_s,
                )
            if i % tc.log_every == 0:
                log.info("step %5d loss %.4f lr %.2e", i, loss, float(metrics["lr"]))
            losses.append(loss)
            new_state = {"params": params, "opt": opt}
            if ef is not None:
                new_state["ef"] = ef
            return new_state, {"loss": loss}

        t0 = time.time()
        state, result = resilient_loop(
            state=self.state,
            step_fn=one_step,
            num_steps=tc.steps,
            ckpt=ckpt,
            ckpt_every=tc.ckpt_every,
        )
        wall = time.time() - t0
        ckpt.close()
        self.state = state
        return {
            "final_step": result.final_step,
            "restarts": result.restarts,
            "losses": losses,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "wall_s": wall,
            "straggler_events": len(self.monitor.events),
            "tokens_per_s": (
                tc.steps * tc.global_batch * tc.seq_len / wall if wall else 0
            ),
        }


def parse_args(argv=None) -> tuple[TrainConfig, str]:
    """The command line as (TrainConfig, device)."""
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b", choices=C.ARCHS)
    p.add_argument("--smoke", action="store_true", default=False)
    p.add_argument("--full", dest="smoke", action="store_false")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--collectives", choices=("xla", "torrent"), default="xla")
    p.add_argument("--num-chains", default="1",
                   help="torrent sub-rings K, or 'auto' (requires "
                        "--collectives torrent)")
    p.add_argument("--compress-grads", action="store_true", default=False,
                   help="int8 wire for the DP gradient all-reduce with "
                        "error-feedback residuals (requires --collectives "
                        "torrent)")
    p.add_argument("--bucket-mb", type=float, default=None,
                   help="bucket size (MiB) for the bucketed DP grad reduce "
                        "(requires --collectives torrent)")
    p.add_argument("--topology", default=None,
                   help="tiered link-graph spec for auto-K ring planning, "
                        "e.g. 'pods=2:interpod_bw=0.25' (requires "
                        "--collectives torrent)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks per DP rank (under torchrun only: the "
                        "stacked view has no TP form)")
    p.add_argument("--dp", type=int, default=1,
                   help="virtual data-parallel ranks, run on the one device (under "
                        "torchrun: one rank per process, so 1 or the world size)")
    p.add_argument("--layers", type=int, default=None,
                   help="depth cut: train the config's first N layers")
    p.add_argument("--remat", default="dots")
    p.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--fail-at", default="",
                   help="comma-separated steps for fault injection demo")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    tc = TrainConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.batch, seq_len=args.seq, peak_lr=args.lr,
        collectives=args.collectives,
        num_chains=args.num_chains if args.num_chains == "auto" else int(args.num_chains),
        compress_grads=args.compress_grads,
        bucket_bytes=(
            int(args.bucket_mb * (1 << 20)) if args.bucket_mb else None
        ),
        topology=args.topology,
        tp=args.tp, dp=args.dp, layers=args.layers, remat=args.remat,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at=tuple(int(s) for s in args.fail_at.split(",") if s),
    )
    return tc, args.device


def main(argv=None) -> dict:
    """Train from the command line; under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) as one rank of the process form, which joins the
    process group here and leaves it on return."""
    tc, device = parse_args(argv)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if launched:
        device = init_from_env(device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    logging.basicConfig(level=logging.INFO if rank0 else logging.WARNING, format="%(message)s")
    try:
        out = Trainer(tc, device=device).run()
    finally:
        if launched:
            dist.destroy_process_group()
    log.info(
        "done: %d steps (%d restarts)  loss %.4f -> %.4f  %.1f tok/s",
        out["final_step"], out["restarts"], out["first_loss"],
        out["last_loss"], out["tokens_per_s"],
    )
    return out


if __name__ == "__main__":
    main()
