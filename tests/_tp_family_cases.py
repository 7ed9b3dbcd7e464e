"""Tensor parallelism for the MoE, MLA, Mamba-2 and hybrid families in
the process form: what each spawned rank runs, for
``tests/test_torch_tp_families.py`` (gloo ranks on the CPU).

Spawned ranks import this module, so it imports torch and the port
only. Every function returns numpy arrays and plain numbers; the tests
hold them against the port at TP = 1 and against JAX.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from _tp_cases import LINEAR_ADAMW, compute_dtype, mesh_info

# smoke configs: deepseek-moe-16b (MoE, 8 experts + 2 shared),
# deepseek-v2-lite-16b (MLA + MoE), mamba2-2.7b (16 heads, 1 group),
# jamba-v0.1-52b (Mamba with 2 groups, GQA with 2 KV heads, 4 experts)
ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b", "mamba2-2.7b", "jamba-v0.1-52b")
# depth cuts: jamba's first 5 of its 8 smoke layers (Mamba with a dense
# FFN and with a MoE, twice, then its GQA layer) hold every layer kind
# and compile in JAX in half the time
LAYERS = {"jamba-v0.1-52b": 5}
B, S = 8, 16
LOSS_CHUNKS = 2
# the edge configs, each from an arch's smoke config, with port-drawn
# params: the rowwise MoE dispatch; 6 experts (whole at TP = 4, 3 a rank
# at TP = 2; the shared experts' 64 columns split at both); d_inner = 126
# in heads of 7 (whole at TP = 4, 9 heads a rank at TP = 2)
EDGES = {
    "moe_rowwise": ("deepseek-moe-16b", dict(moe_row_dispatch=True)),
    "experts_6": ("deepseek-moe-16b", dict(num_experts=6)),
    "d_inner_126": ("mamba2-2.7b", dict(d_model=63, ssm_headdim=7)),
}
# qwen2-vl (embeddings at M-RoPE positions, qkv biases) and whisper (its
# encoder, cross-attention and GeLU FFNs; the smoke vocab of 256 splits,
# whisper-tiny's 51,865 does not), and whisper with 6 heads under JAX's
# opt-seq variant, whose query sequence is sharded at every TP size (1.5
# heads a rank at TP = 4); each with its JAX reference's step
FIXED = ("qwen2-vl-7b", "whisper-tiny", "whisper_6_heads_opt_seq")
FIXED_EDGES = {"whisper_6_heads_opt_seq": ("whisper-tiny", "opt-seq",
                                           dict(num_heads=6, num_kv_heads=6))}
JAX_COLLECTIVES = {"whisper_6_heads_opt_seq": "xla"}  # JAX's opt-seq cell's step
# the Trainer at TP = 2 against the stacked one (f32 compute, exact)
TRAINER = dict(smoke=True, steps=4, global_batch=B, seq_len=S, peak_lr=2e-3, warmup_steps=2,
               ckpt_every=2, loss_chunks=LOSS_CHUNKS, log_every=100, collectives="torrent")
NORM_SHAPE = (2, 5, 24)  # (B, S, d_inner) of the gated norm's direct check


def config(arch: str):
    """The smoke config of ``arch``, cut to ``LAYERS`` (a :data:`FIXED`
    edge: its variant's overrides, then its own)."""
    from repro_torch import configs as C
    from repro_torch.launch.steps import VARIANTS

    if arch in FIXED_EDGES:
        base, variant, changes = FIXED_EDGES[arch]
        return dataclasses.replace(C.get_smoke_config(base), **VARIANTS[variant], **changes)
    cfg = C.get_smoke_config(arch)
    return dataclasses.replace(cfg, num_layers=LAYERS.get(arch, cfg.num_layers))


def init_params(cfg) -> dict:
    """``cfg``'s params, drawn by the port from seed 0, as numpy."""
    from repro_torch.models import transformer as T
    from repro_torch.tree import map_tree

    full = T.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    return map_tree(lambda t: t.numpy(), full)


def edge_config(name: str):
    from repro_torch import configs as C

    arch, changes = EDGES[name]
    return dataclasses.replace(C.get_smoke_config(arch), **changes)


def batch(vocab: int, cfg=None) -> dict:
    """The global batch: tokens and labels; a vlm's embeddings and
    (3, B, S) M-RoPE positions instead of tokens, an encoder-decoder's
    frames besides them (``cfg``)."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if cfg is not None and cfg.family == "vlm":
        del out["tokens"]
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        out["positions"] = rng.integers(0, 3 * S, (3, B, S)).astype(np.int32)
    if cfg is not None and cfg.is_encdec:
        out["enc_frames"] = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(
            np.float32)
    return out


def rank_rows(batch_np: dict, dp: int, i: int, device) -> dict:
    """DP rank ``i``'s rows of ``batch_np`` (the batch axis of each leaf by
    ``batch_pspecs``: axis 1 of M-RoPE positions), as tensors."""
    n = B // dp
    return {k: torch.from_numpy(np.ascontiguousarray(
        v[:, i * n:(i + 1) * n] if k == "positions" else v[i * n:(i + 1) * n])).to(device)
        for k, v in batch_np.items()}


def norm_inputs() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """x, z, the scale and the loss weight of the gated norm's check."""
    rng = np.random.default_rng(5)
    x, z, w = (rng.standard_normal(NORM_SHAPE).astype(np.float32) for _ in range(3))
    return x, z, (1 + 0.1 * rng.standard_normal(NORM_SHAPE[-1])).astype(np.float32), w


def _np(tree) -> list[np.ndarray]:
    from repro_torch.tree import leaves

    return [t.detach().cpu().float().numpy().copy() for t in leaves(tree)]


def family_case(mesh, cfg, params_np, device, steps: bool = True) -> dict:
    """``cfg``'s model on ``mesh`` from the logical ``params_np``: the
    first-step grads in f32 compute, gathered; with ``steps``, two
    Torrent train steps in f32 compute (losses, and the gathered params
    on model rank 0) and two in bf16 (losses, this rank's own leaves and
    which of them are split, the model group's payload bytes of the
    first step)."""
    from repro_torch.data.pipeline import make_device_placer
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.spec import P
    from repro_torch.parallel.tp import tp_counter
    from repro_torch.tree import leaves, map_tree

    tp = mesh.shape["model"]
    specs = shd.logical_pspecs(cfg, tp)
    if cfg.family in ("vlm", "audio"):
        local = rank_rows(batch(cfg.vocab_size, cfg), mesh.shape["data"], mesh.dp_index, device)
    else:
        local = make_device_placer(mesh, P(shd.BATCH_AXES, None), device=device)(
            batch(cfg.vocab_size))
    params = params_from_numpy(params_np, device, specs=specs, mesh=mesh)
    out = {"dp_index": mesh.dp_index, "shard_shapes": [tuple(p.shape) for p in leaves(params)]}
    # the rank's own grads, as the Torrent step's shard_map rank takes them
    # (a MoE's capacity from its own tokens)
    with hints.set_mesh(mesh), hints.manual_axes(("data",)), compute_dtype(torch.float32):
        grads, m = make_grad_fn(cfg, loss_chunks=LOSS_CHUNKS)(params, local)
        out["loss0_f32"] = float(m["loss"])
        out["grads_f32"] = _np(shd.gather_tree(grads, specs, mesh))
    if not steps:
        return out
    step = make_train_step(cfg, adamw.OptConfig(**LINEAR_ADAMW), collectives="torrent",
                           mesh=mesh, loss_chunks=LOSS_CHUNKS)
    first = map_tree(torch.clone, params)
    for dtype in (torch.float32, torch.bfloat16):
        params = map_tree(torch.clone, first)  # the step updates its state in place
        opt = adamw.init(params, specs=shd.train_state_specs(cfg, mesh)["opt"], mesh=mesh)
        tp_counter.reset()
        with compute_dtype(dtype):
            params, opt, m1 = step(params, opt, local)
            tp_bytes = dict(tp_counter.bytes)
            params, opt, m2 = step(params, opt, local)
        losses = [float(m1["loss"]), float(m2["loss"])]
        if dtype == torch.float32:
            out["losses_f32"] = losses
            gathered = _np(shd.gather_tree(params, specs, mesh))
            if mesh.coords["model"] == 0:
                out["params_f32"] = gathered
    out.update(losses=losses, tp_bytes=tp_bytes, local=_np({"params": params, "opt": opt}))
    out["split"] = leaves(map_tree(lambda s: shd.is_split(s, mesh),
                                   shd.train_state_specs(cfg, mesh)))
    return out


def norm_case(group, device="cpu") -> dict:
    """``gated_rmsnorm`` of this rank's block of :func:`norm_inputs`'
    ``d_inner`` over ``group`` (``None``: the whole ``d_inner``): its
    output and the grads of ``x``, ``z`` and the scale for the loss
    ``sum(out * w)``."""
    import torch.distributed as dist

    from repro_torch.models.layers import gated_rmsnorm

    r, n = (0, 1) if group is None else (dist.get_rank(group), dist.get_world_size(group))
    k = NORM_SHAPE[-1] // n
    x, z, scale, w = (torch.from_numpy(np.ascontiguousarray(a[..., r * k:(r + 1) * k]))
                      .to(device) for a in norm_inputs())
    x.requires_grad_(True)
    z.requires_grad_(True)
    scale.requires_grad_(True)
    y = gated_rmsnorm({"scale": scale}, x, z, 1e-5, group)
    (y * w).sum().backward()
    return {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy(),
            "dz": z.grad.cpu().numpy(), "dscale": scale.grad.cpu().numpy()}


def moe_case(mesh, device) -> dict:
    """One MoE layer of the smoke deepseek-moe-16b (8 experts, 2 shared)
    in f32 compute, flat and rowwise, on 2 x 16 tokens: on ``mesh``
    (this rank's experts and shared-expert columns) and unsplit (no
    mesh, the whole layer) from the same params and inputs. For each,
    the output, the aux loss, and the grads of the input, the router and
    the experts (gathered) for the loss ``sum(out * w) + aux``."""
    from repro_torch import configs as C
    from repro_torch.models import moe
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import map_tree

    rng = np.random.default_rng(3)
    cfg = C.get_smoke_config("deepseek-moe-16b")
    full = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x_np = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    w_np = rng.standard_normal(x_np.shape).astype(np.float32)
    specs = shd.param_pspecs({"ffn": full}, cfg, tp=mesh.shape["model"])["ffn"]
    out = {}
    for path in ("flat", "rowwise"):
        c = dataclasses.replace(cfg, moe_row_dispatch=path == "rowwise")
        for name, m in (("split", mesh), ("whole", None)):
            p = map_tree(lambda t: t.clone().to(device),
                         shd.shard_tree(full, specs, mesh) if m else full)
            for leaf in (p["router"], p["wg"]):
                leaf.requires_grad_(True)
            x = torch.from_numpy(x_np).to(device).requires_grad_(True)
            with hints.set_mesh(m), compute_dtype(torch.float32):
                y, aux = moe.moe_apply(p, x, c)
            ((y * torch.from_numpy(w_np).to(device)).sum() + aux).backward()
            wg = p["wg"].grad
            if m is not None:
                wg = shd.gather_tree(wg, specs["wg"], mesh)
            out[f"{path}/{name}"] = {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
                                     "dx": x.grad.cpu().numpy(),
                                     "drouter": p["router"].grad.cpu().numpy(),
                                     "dwg": wg.cpu().numpy()}
    return out


def card_world(rank: int, world: int, device) -> dict:
    """(data=1, model=world): the gated norm over the model group and
    unsplit, and :func:`moe_case`."""
    from repro_torch.launch.mesh import make_process_mesh

    mesh = make_process_mesh(model=world)
    return {"norm": norm_case(mesh.group("model"), device), "norm_whole": norm_case(None, device),
            "coord": mesh.coords["model"], "moe": moe_case(mesh, device)}


def refusals(mesh, device) -> dict:
    """The message a head-cutting ``d_inner`` split raises with on
    ``mesh``, or ``None`` where the forward runs."""
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd

    tp = mesh.shape["model"]
    cfg = dataclasses.replace(C.get_smoke_config("mamba2-2.7b"), ssm_headdim=64)
    full = T.model_init(torch.Generator().manual_seed(0), cfg, device)
    params = shd.shard_tree(full, shd.param_pspecs(full, cfg, tp=tp), mesh)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=device)
    try:
        with hints.set_mesh(mesh):
            T.loss_fn(params, cfg, {"tokens": toks, "labels": toks}, loss_chunks=1)
        return {"cut_head": None}
    except NotImplementedError as e:
        return {"cut_head": str(e)}


def _cases(mesh, params_np: dict, device, fixed: bool = True) -> dict:
    """Every arch's and every edge config's :func:`family_case` on
    ``mesh`` (the edges' first-step grads only), with ``fixed`` those of
    :data:`FIXED` too."""
    out = {arch: family_case(mesh, config(arch), params_np[arch], device)
           for arch in ARCHS + (FIXED if fixed else ())}
    for name in EDGES:
        cfg = edge_config(name)
        out[name] = family_case(mesh, cfg, init_params(cfg), device, steps=False)
    return out


def world4_rank(rank: int, world: int, device, params_np: dict) -> dict:
    """(data=1, model=4) and (data=2, model=2) on 4 ranks: the family
    cases on both meshes, the gated norm over both model groups, and the
    head-cutting split at TP = 4."""
    from repro_torch.launch.mesh import make_process_mesh

    meshes = {"1x4": make_process_mesh(model=4), "2x2": make_process_mesh(data=2, model=2)}
    out = {"mesh": {k: mesh_info(m) for k, m in meshes.items()},
           "norm": {k: norm_case(m.group("model")) for k, m in meshes.items()},
           "refusals": refusals(meshes["1x4"], device)}
    out["cases"] = {k: _cases(m, params_np, device) for k, m in meshes.items()}
    return out


def world2_rank(rank: int, world: int, device, params_np: dict, root: str) -> dict:
    """(data=1, model=2) on 2 ranks: the family cases, the gated norm,
    and each arch's ``Trainer`` at TP = 2 (f32 compute, checkpoints
    every 2 steps under ``root/ARCH``): its losses and gathered state."""
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.parallel import sharding as shd

    mesh = make_process_mesh(model=2)
    out = {"mesh": mesh_info(mesh), "norm": {"1x2": norm_case(mesh.group("model"))},
           "refusals": refusals(mesh, device),
           "cases": {"1x2": _cases(mesh, params_np, device, fixed=False)}}
    out["trainer"] = {}
    for arch in ARCHS:
        tr = Trainer(TrainConfig(arch=arch, ckpt_dir=os.path.join(root, arch), tp=2,
                                 layers=LAYERS.get(arch), **TRAINER),
                     device=device, params=params_np[arch])
        with compute_dtype(torch.float32):
            res = tr.run()
        out["trainer"][arch] = {"losses": res["losses"],
                                "state": _np(shd.gather_tree(tr.state, tr.specs, mesh))}
    return out
