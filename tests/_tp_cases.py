"""Tensor parallelism in the process form: what each spawned rank runs,
for ``tests/test_torch_tp.py`` (gloo ranks on the CPU) and
``tests/test_torch_cuda.py`` (two gloo ranks sharing the card).

Spawned ranks import this module, so it imports torch and the port
only. Every function returns numpy arrays and plain numbers; the tests
hold them against the port at TP = 1 and against JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

ARCH = "yi-6b"  # smoke: 4 heads, 2 KV heads (TP = 4 splits a KV head)
ARCHS = ("starcoder2-3b", "yi-6b", "h2o-danube-1.8b", "llama3-8b", "deepseek-v2-lite-16b",
         "deepseek-moe-16b", "jamba-v0.1-52b", "qwen2-vl-7b", "mamba2-2.7b", "whisper-tiny")
# the two families TP covered last (M-RoPE; the encoder-decoder): they
# train and serve at TP = 2, where their refusals once stood
LEFT_OUT = {"qwen2-vl-7b": "M-RoPE", "whisper-tiny": "encoder-decoder"}
# a first AdamW step linear in the grads (eps = 1), for comparing updates
LINEAR_ADAMW = dict(peak_lr=1e-2, warmup_steps=1, decay_steps=10, eps=1.0)
TRAINER = dict(arch=ARCH, smoke=True, steps=6, global_batch=8, seq_len=32, peak_lr=2e-3,
               warmup_steps=3, ckpt_every=2, loss_chunks=2, log_every=100,
               collectives="torrent")
# the Trainer runs: exact in f32 compute, so that AdamW's sign-like early
# updates cannot amplify bf16 rounding, across a failure and a restart;
# int8 + EF in bf16
TRAINER_RUNS = {"exact": dict(fail_at=(3,)), "int8": dict(compress_grads=True)}
OPS_SHAPE = (3, 4, 8)  # each rank's input to the conjugate ops


class compute_dtype:
    """Set ``models.layers.COMPUTE_DTYPE`` inside the block."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from repro_torch.models import layers as LY

        self.old, LY.COMPUTE_DTYPE = LY.COMPUTE_DTYPE, self.dtype

    def __exit__(self, *exc):
        from repro_torch.models import layers as LY

        LY.COMPUTE_DTYPE = self.old


def _np(tree) -> list[np.ndarray]:
    from repro_torch.tree import leaves

    return [t.detach().cpu().float().numpy().copy() for t in leaves(tree)]


def ops_inputs(rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Rank ``rank``'s input ``x`` and the weight ``w`` of its loss
    ``sum(op(x) * w)`` (``w`` has ``x``'s shape; gather's loss weight is
    ``w`` tiled to the gathered shape by the test)."""
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(OPS_SHAPE).astype(np.float32),
            rng.standard_normal(OPS_SHAPE).astype(np.float32))


def ce_inputs(vocab: int = 24, rows: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Logits (rows, vocab) and labels (rows,) of the vocab-parallel CE."""
    rng = np.random.default_rng(7)
    return ((rng.standard_normal((rows, vocab)) * 3).astype(np.float32),
            rng.integers(0, vocab, rows).astype(np.int64))


def ops_rank(group, device) -> dict:
    """``copy_to_tp``, ``reduce_from_tp`` and ``gather_from_tp`` (dim 1)
    on this rank's inputs over ``group``: each output and the grad of
    ``sum(out * w)`` (gather: ``w`` tiled along dim 1); and the
    vocab-parallel CE of this rank's block of :func:`ce_inputs`, with
    its logits' grad."""
    import torch.distributed as dist

    from repro_torch.parallel import tp as TPm

    rank, n = dist.get_rank(group), dist.get_world_size(group)
    x_np, w_np = ops_inputs(rank)
    out = {}
    for name, fn in (("copy", lambda t: TPm.copy_to_tp(t, group)),
                     ("reduce", lambda t: TPm.reduce_from_tp(t, group)),
                     ("gather", lambda t: TPm.gather_from_tp(t, group, 1))):
        x = torch.from_numpy(x_np).to(device).requires_grad_(True)
        w = torch.from_numpy(np.concatenate([w_np] * n, 1) if name == "gather" else w_np)
        y = fn(x)
        (y * w.to(device)).sum().backward()
        out[name] = (y.detach().cpu().numpy(), x.grad.cpu().numpy())
    logits, labels = ce_inputs()
    V = logits.shape[1] // n
    lg = torch.from_numpy(logits[:, rank * V:(rank + 1) * V]).to(device).requires_grad_(True)
    ce, zl = TPm.vocab_parallel_ce(lg, torch.from_numpy(labels).to(device), group, 1e-2)
    (ce + zl).backward()
    out["ce"] = (float(ce), float(zl), lg.grad.cpu().numpy())
    return out


def ops_world(rank: int, world: int, device) -> dict:
    """:func:`ops_rank` over the model group of ``(data=1, model=world)``."""
    from repro_torch.launch.mesh import make_process_mesh

    return ops_rank(make_process_mesh(model=world).group("model"), device)


def round_trip(mesh, tp: int) -> dict:
    """Every arch's smoke params through ``shard_tree`` and back through
    ``gather_tree`` on ``mesh``: whether each leaf comes back equal, and
    this rank's shard shapes."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves

    out = {}
    for arch in ARCHS:
        cfg = C.get_smoke_config(arch)
        full = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
        specs = shd.param_pspecs(full, cfg, tp=tp)
        shards = shd.shard_tree(full, specs, mesh)
        back = shd.gather_tree(shards, specs, mesh)
        out[arch] = (all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(full))),
                     [tuple(s.shape) for s in leaves(shards)])
    return out


def train_case(mesh, params_np, batch_np, device) -> dict:
    """The smoke model on ``mesh`` from the carried logical params: the
    first-step grads (bf16 and f32 compute) gathered, the clipping norm
    of this rank's shards against the gathered tree's, two Torrent train
    steps (losses, grad norms, gathered params, this rank's own leaves),
    the DP wire bytes and the TP payload bytes of the first step."""
    from repro_torch import configs as C
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.data.pipeline import make_device_placer
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import P
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.tree import leaves, map_tree

    cfg = C.get_smoke_config(ARCH)
    tp = mesh.shape["model"]
    specs = shd.logical_pspecs(cfg, tp)
    split = map_tree(lambda s: shd.is_split(s, mesh), specs)
    place = make_device_placer(mesh, P(shd.BATCH_AXES, None), device=device)
    local = place(batch_np)
    params = params_from_numpy(params_np, device, specs=specs, mesh=mesh)
    out = {"rows": local["tokens"].cpu().numpy(), "dp_index": mesh.dp_index,
           "shard_shapes": [tuple(p.shape) for p in leaves(params)]}

    grad_fn = make_grad_fn(cfg, loss_chunks=2)
    with hints.set_mesh(mesh):
        grads, m = grad_fn(params, local)
        out["loss0"] = float(m["loss"])
        out["grads"] = _np(shd.gather_tree(grads, specs, mesh))
        norm = adamw.global_norm(grads, group=mesh.group("model"), split=split)
        out["norm"] = (float(norm), float(adamw.global_norm(shd.gather_tree(grads, specs, mesh))))
        with compute_dtype(torch.float32):
            out["grads_f32"] = _np(shd.gather_tree(grad_fn(params, local)[0], specs, mesh))

    step = make_train_step(cfg, adamw.OptConfig(**LINEAR_ADAMW), collectives="torrent",
                           mesh=mesh, loss_chunks=2)
    opt = adamw.init(params, specs=shd.train_state_specs(cfg, mesh)["opt"], mesh=mesh)
    cwd.wire_counter.reset()
    tp_counter.reset()
    params, opt, m1 = step(params, opt, local)
    out["dp_wire_bytes"] = cwd.wire_counter.bytes
    out["tp_bytes"] = dict(tp_counter.bytes)
    out["shard_bytes"] = [p.numel() * 4 for p in leaves(params)]
    params, opt, m2 = step(params, opt, local)
    out["losses"] = [float(m1["loss"]), float(m2["loss"])]
    out["grad_norms"] = [float(m1["grad_norm"]), float(m2["grad_norm"])]
    out["params"] = _np(shd.gather_tree(params, specs, mesh))
    out["local"] = _np(params)
    out["split"] = leaves(split)
    return out


def zero1_case(mesh, params_np, batch_np, device) -> dict:
    """ZeRO-1 on ``mesh`` (a live ``data`` axis) from the carried logical
    params: the bytes of the rank's moments (its blocks by
    ``opt_pspecs``) beside the whole moments of its params; one reduced
    grad applied by ``adamw.update`` to whole moments and by
    ``adamw.update_zero1`` to the blocks (params, and the moments' blocks,
    compared bit for bit); then two train steps from the carried params
    with the Torrent reduce and with ``collectives="xla"``: losses,
    grad norms, the gathered params, the rank's moment blocks, the
    param gather's bytes a step and the spans' names."""
    from repro_torch import configs as C
    from repro_torch.data.pipeline import make_device_placer
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import torrent_grad_reduce
    from repro_torch.parallel.spec import P
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves, map_tree

    cfg = C.get_smoke_config(ARCH)
    tp = mesh.shape["model"]
    st = shd.train_state_specs(cfg, mesh)
    local = make_device_placer(mesh, P(shd.BATCH_AXES, None), device=device)(batch_np)
    first = params_from_numpy(params_np, device, specs=st["params"], mesh=mesh)
    opt = adamw.init(first, specs=st["opt"], mesh=mesh)
    out = {"moment_shapes": [tuple(m.shape) for m in leaves(opt["mu"])],
           "moment_bytes": sum(m.numel() * m.element_size() for k in ("mu", "nu")
                               for m in leaves(opt[k])),
           "whole_moment_bytes": 2 * sum(p.numel() * 4 for p in leaves(first)),
           "param_bytes": sum(p.numel() * p.element_size() for p in leaves(first)),
           "split_param_bytes": sum(p.numel() * p.element_size() for p, m in
                                    zip(leaves(first), leaves(opt["mu"]))
                                    if m.shape != p.shape)}

    # the block update against the whole update of the same reduced grads
    norm_kw = {}
    if tp > 1:
        norm_kw = dict(group=mesh.group("model"), split=map_tree(
            lambda s: shd.is_split(s, mesh), st["params"]))
    opt_cfg = adamw.OptConfig(**LINEAR_ADAMW)
    with hints.set_mesh(mesh):
        grads, _ = torrent_grad_reduce(make_grad_fn(cfg, loss_chunks=2), mesh)(
            map_tree(torch.clone, first), local)
    whole_p = map_tree(torch.clone, first)
    whole_o = adamw.init(whole_p)
    adamw.update(opt_cfg, grads, whole_o, whole_p, **norm_kw)
    block_p = map_tree(torch.clone, first)
    block_o = adamw.init(block_p, specs=st["opt"], mesh=mesh)
    adamw.update_zero1(opt_cfg, grads, block_o, block_p, specs=st["opt"]["mu"], mesh=mesh,
                       **norm_kw)
    out["block_update_bit_equal"] = {
        "params": all(torch.equal(a, b) for a, b in zip(leaves(whole_p), leaves(block_p))),
        **{k: all(torch.equal(adamw.zero1_block(w, s, mesh), b) for w, b, s in
                  zip(leaves(whole_o[k]), leaves(block_o[k]), leaves(st["opt"][k])))
           for k in ("mu", "nu")}}

    for collectives in ("torrent", "xla"):
        spans = Spans()
        step = make_train_step(cfg, opt_cfg, collectives=collectives, mesh=mesh, loss_chunks=2,
                               spans=spans)
        params = map_tree(torch.clone, first)
        opt = adamw.init(params, specs=st["opt"], mesh=mesh)
        adamw.gather_counter.reset()
        params, opt, m1 = step(params, opt, local)
        gathered = adamw.gather_counter.bytes
        params, opt, m2 = step(params, opt, local)
        out[collectives] = {"losses": [float(m1["loss"]), float(m2["loss"])],
                            "grad_norms": [float(m1["grad_norm"]), float(m2["grad_norm"])],
                            "params": _np(shd.gather_tree(params, st["params"], mesh)),
                            "mu": _np(opt["mu"]), "nu": _np(opt["nu"]),
                            "step": int(opt["step"]), "gather_bytes": gathered,
                            "spans": sorted(spans.read())}
    return out


# the train cells every arch builds on a process mesh, at full size on
# the meta device (whisper-tiny's 6 heads at TP = 4 only as opt-seq)
CELL_ARCHS = ("starcoder2-3b", "yi-6b", "h2o-danube-1.8b", "llama3-8b", "deepseek-v2-lite-16b",
              "deepseek-moe-16b", "jamba-v0.1-52b", "mamba2-2.7b", "qwen2-vl-7b", "whisper-tiny")
SERVE_SHAPES = ("prefill_32k", "decode_32k")
# the smoke train cells run one step against JAX's cell: name -> (arch,
# mesh, collectives). The MoE cell's Torrent reduce takes each rank's
# own capacity, as JAX's shard_map ranks do; its xla step the global
# batch's, as JAX's GSPMD step does
SMOKE_TRAIN_CELLS = {"yi-6b": ("yi-6b", "2x2", "xla"),
                     "deepseek-moe-16b": ("deepseek-moe-16b", "2x2", "torrent"),
                     "deepseek-moe-16b/xla": ("deepseek-moe-16b", "2x2", "xla"),
                     "qwen2-vl-7b": ("qwen2-vl-7b", "2x2", "xla"),
                     "whisper-tiny": ("whisper-tiny", "2x2", "xla"),
                     "deepseek-moe-16b/moe-ep": ("deepseek-moe-16b", "2x2", "torrent")}
# the cells that take a variant, and how many steps they run (default:
# baseline, one): the moe-ep cell, EP over data under a live model axis
CELL_VARIANTS = {"deepseek-moe-16b/moe-ep": ("moe-ep", 2)}
SMOKE_TRAIN = ("train_smoke", "train", 32, 4)  # JAX's smoke train shape
# the moe-ep cell's xla step, held against its Torrent step: JAX's xla
# step never reaches EP (ROADMAP §3), so it has no JAX counterpart
EP_XLA_CELL = ("deepseek-moe-16b/moe-ep/xla", ("deepseek-moe-16b", "2x2", "xla"))
# EP under TP: the smoke deepseek-moe-16b (8 experts, top-2) with
# moe_ep_dispatch on (2, 2); a MoE layer's input (B_EP rows of S_EP)
EP_ARCH, B_EP, S_EP = "deepseek-moe-16b", 4, 8


def meta_train_cells(mesh, archs, variant: str = "baseline", shape: str = "train_4k") -> dict:
    """``build_cell(arch, shape, mesh, variant=)`` on the meta device for
    each of ``archs``: every arg's leaf shapes, whether every arg is a
    meta tensor, the in and out specs; or the message of a refusal."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import leaves

    out = {}
    for arch in archs:
        try:
            cell = build_cell(arch, shape, mesh, variant=variant)
        except NotImplementedError as e:
            out[arch] = {"refused": str(e)}
            continue
        out[arch] = {"args": [[tuple(x.shape) for x in leaves(a)] for a in cell.args],
                     "meta": all(x.device.type == "meta" for x in leaves(cell.args)),
                     "in_specs": [[None if s is None else tuple(s) for s in leaves(t)]
                                  for t in cell.in_specs],
                     "out_specs": [None if t is None else
                                   [None if s is None else tuple(s) for s in leaves(t)]
                                   for t in cell.out_specs]}
    return out


def smoke_train_cell(name: str, mesh, device) -> dict:
    """One step of ``arch``'s smoke train cell on ``mesh`` in f32
    compute, from the cell's own args (seed 0 params, seed 1 batch):
    the loss, the grad norm, the payload this process handed the model
    group and the MoE exchange, the rank's ``mu`` blocks, the params
    gathered and whether every param leaf moved."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.tree import leaves

    arch, _, collectives = dict([EP_XLA_CELL]).get(name) or SMOKE_TRAIN_CELLS[name]
    variant, steps = CELL_VARIANTS.get(name.removesuffix("/xla"), ("baseline", 1))
    C.SHAPES[SMOKE_TRAIN[0]] = Shape(*SMOKE_TRAIN)
    cell = build_cell(arch, SMOKE_TRAIN[0], mesh, smoke=True, device=device,
                      collectives=collectives, variant=variant)
    params, opt, batch = cell.args
    before = [p.clone() for p in leaves(params)]
    losses, norms = [], []
    for _ in range(steps):  # the last step's payload
        tp_counter.reset()
        with compute_dtype(torch.float32):
            params, opt, m = cell.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    pspecs = shd.logical_pspecs(cell.cfg, mesh.shape["model"])
    return {"loss": losses[0], "grad_norm": norms[0], "losses": losses, "grad_norms": norms,
            "tp_bytes": dict(tp_counter.bytes),
            "mu": _np(opt["mu"]), "step": int(opt["step"]),
            "moved": all(not torch.equal(a, b) for a, b in zip(before, leaves(params))),
            "params": _np(shd.gather_tree(params, pspecs, mesh))}


def ep_inputs() -> tuple[dict, np.ndarray]:
    """A MoE layer of :data:`EP_ARCH` (the port's init, seed 5) and its
    input ``(B_EP, S_EP, d)`` (seed 6), as numpy."""
    from repro_torch import configs as C
    from repro_torch.models import moe as M
    from repro_torch.tree import map_tree

    cfg = C.get_smoke_config(EP_ARCH)
    p = map_tree(lambda t: t.numpy(), M.moe_init(torch.Generator().manual_seed(5), cfg, "cpu"))
    x = np.random.default_rng(6).standard_normal((B_EP, S_EP, cfg.d_model)).astype(np.float32)
    return p, x


def ep_case(mesh, device) -> dict:
    """Expert parallelism over ``data`` under a live ``model`` axis, f32
    compute: the ``moe_ep_dispatch`` route of one MoE layer on this
    rank's rows of :func:`ep_inputs` (its experts' ``param_pspecs``
    block), its output and aux loss, the EP bytes it sent; the bytes the
    smoke model's grad function sends (the forward's exchanges, the
    remat'd recompute's and the backward's transposes); and the
    ``moe-ep`` decode cell on ``mesh`` (tokens, cache gathered, EP
    bytes)."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.steps import build_cell, make_grad_fn
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import keep_axes
    from repro_torch.tree import map_tree

    tp, dp, i = mesh.shape["model"], mesh.shape["data"], mesh.dp_index
    cfg = dataclasses.replace(C.get_smoke_config(EP_ARCH), moe_ep_dispatch=True)
    p_np, x_np = ep_inputs()
    whole = params_from_numpy(p_np, device)
    params = shd.shard_tree(whole, shd.param_pspecs(whole, cfg, tp=tp), mesh)
    n = B_EP // dp
    x = torch.from_numpy(x_np[i * n:(i + 1) * n]).to(device)
    out = {}
    with torch.no_grad(), compute_dtype(torch.float32), hints.set_mesh(mesh):
        cwd.wire_counter.reset()
        y, aux = M.moe_apply(params, x, cfg)
        out["layer"] = {"out": _np(y), "aux": float(aux), "ep_bytes": cwd.wire_counter.bytes}

    # the smoke model's grads on the rank's rows, the DP axes Manual (the
    # Torrent step's grad function): the EP exchanges alone
    C.SHAPES[SMOKE_TRAIN[0]] = Shape(*SMOKE_TRAIN)
    cell = build_cell(EP_ARCH, SMOKE_TRAIN[0], mesh, smoke=True, device=device, variant="moe-ep")
    cwd.wire_counter.reset()
    with compute_dtype(torch.float32), hints.set_mesh(mesh), hints.manual_axes(("data",)):
        make_grad_fn(cell.cfg, remat="dots", loss_chunks=2)(cell.args[0], cell.args[2])
    out["grad_ep_bytes"] = cwd.wire_counter.bytes

    C.SHAPES["decode_smoke"] = Shape("decode_smoke", "decode", 16, B_EP)
    cell = build_cell(EP_ARCH, "decode_smoke", mesh, smoke=True, device=device, variant="moe-ep")
    cwd.wire_counter.reset()
    with torch.no_grad(), compute_dtype(torch.float32):
        tok, cache = cell.step_fn(*cell.args)
    specs = map_tree(lambda sp: keep_axes(sp, ("model",)), shd.logical_cache_pspecs(
        cell.cfg, cell.shape, B_EP // dp, 16, tp))
    out["decode"] = {"tokens": tok.cpu().numpy().copy(), "ep_bytes": cwd.wire_counter.bytes,
                     "cache": _np(shd.gather_cache(cache, specs, cell.cfg, mesh))}
    return out


def ep_trainers(root: str, device) -> dict:
    """The ``Trainer`` at ``tp=2`` on the world's ``(2, 2)`` mesh with
    :data:`EP_ARCH`'s ``moe_ep_dispatch`` config, in f32 compute, with
    the Torrent and the xla step: the losses of its steps."""
    from repro_torch import configs as C
    from repro_torch.launch.train import TrainConfig, Trainer

    cfg = dataclasses.replace(C.get_smoke_config(EP_ARCH), moe_ep_dispatch=True)
    out = {}
    for coll in ("torrent", "xla"):
        tr = Trainer(TrainConfig(ckpt_dir=os.path.join(root, f"ep_{coll}"), tp=2,
                                 collectives=coll, **EP_TRAINER), device=device, model_cfg=cfg)
        with compute_dtype(torch.float32):
            out[coll] = tr.run()["losses"]
    return out


# the EP Trainer runs (the stacked TP = 1 one with dp=2 alike)
EP_TRAINER = dict(arch=EP_ARCH, smoke=True, steps=2, global_batch=8, seq_len=16,
                  peak_lr=2e-3, warmup_steps=1, ckpt_every=100, loss_chunks=2, log_every=100)


def mesh_forms() -> dict:
    """The meshes in the process form on a 4-rank world:
    ``make_elastic_mesh`` (a ``ProcessMesh`` under ``torch.distributed``)
    and ``make_production_mesh``'s refusal of a world that is not 256 or
    512 ranks."""
    from repro_torch.launch.mesh import ProcessMesh, make_production_mesh
    from repro_torch.runtime.elastic import make_elastic_mesh

    out = {}
    for tp in (2, 4, 3):
        m = make_elastic_mesh(4, tp)
        out[f"elastic_{tp}"] = (type(m) is ProcessMesh, m.shape, dict(m.coords))
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi)
            out[f"production_{multi}"] = None
        except ValueError as e:
            out[f"production_{multi}"] = str(e)
    return out


def zero1_trainer(mesh, params_np, root: str, device) -> dict:
    """The ``Trainer`` on ``mesh`` (``TRAINER`` with ``TRAINER_RUNS``'
    exact run: f32 compute, a failure at step 3 and a restart from the
    step-2 checkpoint), its state placed by ``train_state_specs``: the
    losses, the restarts and the gathered state (its checkpoints in
    ``root``)."""
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.parallel import sharding as shd

    tp = mesh.shape["model"]
    tr = Trainer(TrainConfig(ckpt_dir=root, tp=tp, **TRAINER, **TRAINER_RUNS["exact"]),
                 device=device, params=params_np)
    with compute_dtype(torch.float32):
        res = tr.run()
    return {"losses": res["losses"], "restarts": res["restarts"],
            "moment_shapes": [tuple(m.shape) for m in _leaves(tr.state["opt"]["mu"])],
            "state": _np(shd.gather_tree(tr.state, tr.specs, mesh))}


def restore_placed(ckpt_dir: str, mesh, device) -> list[np.ndarray]:
    """The latest checkpoint in ``ckpt_dir`` (params and AdamW state)
    restored on ``mesh``: this rank's blocks by ``train_state_specs``."""
    from repro_torch import configs as C
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd

    cfg = C.get_smoke_config(ARCH)
    st = shd.train_state_specs(cfg, mesh)
    p = T.model_init(torch.Generator().manual_seed(5), cfg, device,
                     place=shd.leaf_placer(st["params"], mesh))
    like = {"params": p, "opt": adamw.init(p, specs=st["opt"], mesh=mesh)}
    ckpt = CheckpointManager(ckpt_dir, group=mesh.group(("data",)), mesh=mesh, specs=st)
    got = ckpt.restore(ckpt.latest_step(), like)
    ckpt.close()
    return _np(got)


def refusals(mesh, device) -> dict:
    """The message the training forward of each of :data:`LEFT_OUT`, of a
    dense config whose heads the TP size does not divide (no
    ``attn_seq_shard``) and of a MoE config with ``moe_ep_dispatch``
    (EP over the DP axes composed with experts over ``model``: it
    runs), and
    qwen2-vl's prefill, raise with on ``mesh`` (a live ``model`` axis);
    ``None`` where it runs; and ``attn_seq_shard`` with the flash
    kernel (``seq_flash``)."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd

    tp = mesh.shape["model"]
    out = {}
    cases = {arch: C.get_smoke_config(arch) for arch in LEFT_OUT}
    cases["heads"] = dataclasses.replace(C.get_smoke_config(ARCH), num_heads=3,
                                         num_kv_heads=1, d_model=48)
    cases["moe_ep"] = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"),
                                          moe_ep_dispatch=True)
    cases["seq_flash"] = dataclasses.replace(C.get_smoke_config(ARCH), attn_seq_shard=True,
                                             attn_impl="flash")
    for name, cfg in cases.items():
        full = T.model_init(torch.Generator().manual_seed(0), cfg, device)
        params = shd.shard_tree(full, shd.param_pspecs(full, cfg, tp=tp), mesh)
        S = 8
        batch = {"tokens": torch.zeros((2, S), dtype=torch.int32, device=device),
                 "labels": torch.zeros((2, S), dtype=torch.int32, device=device)}
        if cfg.family == "vlm":
            batch = {"embeds": torch.zeros((2, S, cfg.d_model), device=device),
                     "positions": torch.zeros((3, 2, S), dtype=torch.int32, device=device),
                     "labels": batch["labels"]}
        if cfg.is_encdec:
            batch["enc_frames"] = torch.zeros((2, cfg.encoder_seq_len, cfg.d_model),
                                              device=device)
        try:
            with hints.set_mesh(mesh):
                T.loss_fn(params, cfg, batch, loss_chunks=1)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    # qwen2-vl's prefill on the rank's shards
    cfg = C.get_smoke_config("qwen2-vl-7b")
    full = T.model_init(torch.Generator().manual_seed(0), cfg, device)
    params = shd.shard_tree(full, shd.param_pspecs(full, cfg, tp=tp), mesh)
    try:
        with torch.no_grad(), hints.set_mesh(mesh):
            T.prefill(params, cfg, {"embeds": torch.zeros((1, 4, cfg.d_model), device=device),
                                    "positions": torch.zeros((3, 1, 4), dtype=torch.int32,
                                                             device=device)}, 8)
        out["prefill"] = None
    except NotImplementedError as e:
        out["prefill"] = str(e)
    return out


def mesh_info(mesh) -> dict:
    import torch.distributed as dist

    info = {"coords": dict(mesh.coords), "shape": mesh.shape, "dp_index": mesh.dp_index}
    for name, axes in (("model", "model"), ("data", "data"), ("dp", ("pod", "data")),
                       ("all", mesh.axis_names)):
        axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                     if a in mesh.axis_names)
        g = mesh.group(axes)
        info[name] = (dist.get_rank(g), dist.get_world_size(g))
    return info


def world4_rank(rank: int, world: int, device, params_np, batch_np, root: str,
                stacked_ckpt: str, jax_ckpt: str) -> dict:
    """(data=1, model=4), (data=2, model=2) and (data=4, model=1) on 4
    ranks: the TP meshes' groups, the shard round trip at TP = 4, the
    conjugate ops over both model groups, and the train case on both;
    ZeRO-1 on (2, 2) and (4, 1) (:func:`zero1_case`), the train cells
    there (:func:`meta_train_cells`, :func:`smoke_train_cell`), the
    ``Trainer`` on (2, 2) with its checkpoints in ``root``, restored on
    (4, 1), and the stacked ``Trainer``'s checkpoint (``stacked_ckpt``)
    restored on both, the JAX package's (``jax_ckpt``) on (2, 2); EP
    under TP on (2, 2) (:func:`ep_case`, the moe-ep cell's xla step, the
    EP ``Trainer``s) and the meshes in the process form
    (:func:`mesh_forms`)."""
    from repro_torch.launch.mesh import make_process_mesh

    meshes = {"1x4": make_process_mesh(model=4), "2x2": make_process_mesh(data=2, model=2)}
    dp4 = make_process_mesh(data=4)
    out = {"mesh": {k: mesh_info(m) for k, m in meshes.items()},
           "round_trip": round_trip(meshes["1x4"], 4)}
    out["ops"] = {k: ops_rank(m.group("model"), device) for k, m in meshes.items()}
    out["train"] = {k: train_case(m, params_np, batch_np, device) for k, m in meshes.items()}
    zmeshes = {"2x2": meshes["2x2"], "4x1": dp4}
    out["zero1"] = {k: zero1_case(m, params_np, batch_np, device) for k, m in zmeshes.items()}
    out["meta_cells"] = {k: meta_train_cells(m, CELL_ARCHS) for k, m in
                         {**zmeshes, "1x4": meshes["1x4"]}.items()}
    out["meta_cells"]["1x4/opt-seq"] = meta_train_cells(meshes["1x4"], ("whisper-tiny",),
                                                        "opt-seq")
    for shape in SERVE_SHAPES:  # the serve cells over data alone
        out["meta_cells"][f"4x1/{shape}"] = meta_train_cells(dp4, CELL_ARCHS, shape=shape)
    out["smoke_cells"] = {name: smoke_train_cell(name, zmeshes[m], device)
                          for name, (_, m, _) in SMOKE_TRAIN_CELLS.items() if m in zmeshes}
    out["smoke_cells"][EP_XLA_CELL[0]] = smoke_train_cell(EP_XLA_CELL[0], meshes["2x2"], device)
    out["ep"] = ep_case(meshes["2x2"], device)
    out["ep_trainers"] = ep_trainers(root, device)
    out["mesh_forms"] = mesh_forms()
    d = os.path.join(root, "zero1_2x2")
    out["trainer"] = zero1_trainer(meshes["2x2"], params_np, d, device)
    out["restore"] = {"2x2_at_4x1": restore_placed(d, dp4, device),
                      "stacked_at_2x2": restore_placed(stacked_ckpt, meshes["2x2"], device),
                      "stacked_at_4x1": restore_placed(stacked_ckpt, dp4, device),
                      "jax_at_2x2": restore_placed(jax_ckpt, meshes["2x2"], device)}
    return out


def world2_rank(rank: int, world: int, device, params_np, batch_np, root: str,
                stacked_ckpt: str, jax_ckpt: str) -> dict:
    """(data=1, model=2) on 2 ranks: the round trip at TP = 2, the train
    case, the refusals, the ``Trainer`` at TP = 2 (exact with a failure
    and a restart, and int8 + EF), its checkpoint restored at TP = 1 in
    the process form, and the stacked ``Trainer``'s checkpoint restored
    as this rank's shards."""
    from repro_torch import configs as C
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import ef_residual_init

    mesh = make_process_mesh(model=2)
    out = {"mesh": mesh_info(mesh), "round_trip": round_trip(mesh, 2),
           "ops": ops_rank(mesh.group("model"), device),
           "train": train_case(mesh, params_np, batch_np, device),
           "refusals": refusals(mesh, device)}
    # (data=2, model=1): ZeRO-1 on two ranks, the qwen2-vl and whisper train cells
    dp2 = make_process_mesh(data=2)
    out["zero1"] = {"2x1": zero1_case(dp2, params_np, batch_np, device)}
    out["meta_cells"] = {"2x1": meta_train_cells(dp2, ("qwen2-vl-7b", "whisper-tiny"))}
    out["smoke_cells"] = {name: smoke_train_cell(name, dp2, device)
                          for name, (_, m, _) in SMOKE_TRAIN_CELLS.items() if m == "2x1"}
    for name, kw in TRAINER_RUNS.items():
        tr = Trainer(TrainConfig(ckpt_dir=os.path.join(root, f"tp2_{name}"), tp=2,
                                 **TRAINER, **kw), device=device, params=params_np)
        with compute_dtype(torch.float32 if name == "exact" else torch.bfloat16):
            res = tr.run()
        out[name] = {"losses": res["losses"], "restarts": res["restarts"],
                     "rows": (tr.rows.start, tr.rows.stop),
                     "state": _np(shd.gather_tree(tr.state, tr.specs, mesh)),
                     "ef_shapes": ([tuple(e.shape) for e in _leaves(tr.state["ef"])]
                                   if "ef" in tr.state else None)}

    # the seeded init: each leaf cut as it is drawn, the logical model whole
    cfg = C.get_smoke_config(ARCH)
    full = T.model_init(torch.Generator().manual_seed(0), cfg, device)
    tr = Trainer(TrainConfig(ckpt_dir=os.path.join(root, "seeded"), tp=2, **TRAINER),
                 device=device)
    out["seed_init_equal"] = all(torch.equal(a, b) for a, b in zip(
        _leaves(shd.gather_tree(tr.state["params"], tr.specs["params"], mesh)), _leaves(full)))

    # the TP = 2 checkpoint at TP = 1 in the process form: every leaf whole
    like = {"params": full, "opt": adamw.init(full)}
    dp_mesh = make_process_mesh()
    ckpt = CheckpointManager(os.path.join(root, "tp2_exact"), group=dp_mesh.group("data"))
    out["tp1_restore"] = _np(ckpt.restore(ckpt.latest_step(), like))
    ckpt.close()

    # the stacked form's checkpoint (exact and int8 + EF) as this rank's shards
    specs = shd.logical_pspecs(cfg, 2)
    shards = shd.shard_tree(full, specs, mesh)
    like = {"params": shards, "opt": adamw.init(shards), "ef": ef_residual_init(shards, 1)}
    st = shd.state_specs(specs, mesh, ef=True)
    ckpt = CheckpointManager(stacked_ckpt, group=mesh.group("data"), mesh=mesh, specs=st)
    out["tp2_restore"] = _np(ckpt.restore(ckpt.latest_step(), like))
    ckpt.close()
    # and the JAX package's checkpoint (params and AdamW state)
    like = {"params": shards, "opt": adamw.init(shards)}
    ckpt = CheckpointManager(jax_ckpt, group=mesh.group("data"), mesh=mesh,
                             specs=shd.state_specs(specs, mesh))
    out["jax_restore"] = _np(ckpt.restore(ckpt.latest_step(), like))
    ckpt.close()

    # a logical state placed on the mesh: this rank's shards
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.tree import map_tree

    logical = {"params": map_tree(lambda t: t.numpy(), full), "opt": adamw.init(full)}
    placed = reshard_state(logical, mesh, shd.state_specs(specs, mesh), device=device)
    want = shd.shard_tree({"params": full, "opt": adamw.init(full)},
                          shd.state_specs(specs, mesh), mesh)
    out["reshard_equal"] = all(torch.equal(a, b) for a, b in zip(_leaves(placed),
                                                                 _leaves(want)))
    out["reshard_shapes"] = [tuple(x.shape) for x in _leaves(placed["params"])]
    return out


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)
