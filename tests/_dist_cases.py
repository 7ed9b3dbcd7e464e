"""The process-form executor's cases (``core.chainwrite`` with
``group=``), shared by ``tests/test_torch_dist.py`` (8 gloo ranks on the
CPU) and ``chip_smoke.py``'s dist phase (ranks sharing one card).

A case names a collective and its knobs. :func:`global_input` makes the
stacked view of every rank's input from a seed with numpy;
:func:`run_rank` is the call rank ``r`` makes on its own row over a
group, :func:`run_stacked` the stacked executor's call on the whole view,
whose row ``r`` the rank's result must equal bit for bit. Spawned ranks
import this module, so it imports torch and the port only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import chainwrite as cw
from repro_torch.core import chainwrite_dist as cwd

# (head, destination chains) of the broadcast cases, for 8 devices
CHAINS = [
    (0, [(1, 2, 3, 4, 5, 6, 7)]),
    (0, [(1, 2, 3), (5, 4), (7,)]),
    (3, [(2, 1), (4, 5, 6, 7, 0)]),
    (5, [(0,), (1,), (2,), (7, 6)]),
]
FAILED = [2, (2, 4), (1, 2, 3), 7, (4, 5, 7)]
DTYPES = {"float32": np.float32, "int32": np.int32, "float64": np.float64}


def rings(L: int, K: int, seed: int) -> tuple[tuple[int, ...], ...]:
    """K disjoint equal rings over a scrambled permutation of the axis
    (seed 0: the canonical contiguous split)."""
    perm = np.arange(L) if seed == 0 else np.random.default_rng(seed).permutation(L)
    S = L // K
    return tuple(tuple(int(d) for d in perm[i * S:(i + 1) * S]) for i in range(K))


def cases(L: int = 8, Ks=(1, 2, 4), seeds=(0, 1, 2), frames=(1, 3), full: bool = True) -> list[dict]:
    """The grid of ``tests/test_torch_chainwrite.py`` for ``L`` ranks:
    all-reduce (both algos, both wires, the zero-pad path), all-to-all,
    reduce-scatter, all-gather (stacked and tiled), pipelined and
    degraded broadcasts. ``full=False`` keeps one size and dtype per
    collective."""
    Ks = [k for k in Ks if L % k == 0 and L // k >= 1]
    out = []
    for K in Ks:
        for seed in seeds:
            for algo in ("rs_ag", "rotation"):
                for wire in (None, "int8"):
                    for n in ((24, 13, 1) if full else (24,)):
                        out.append(dict(kind="all_reduce", K=K, seed=seed, algo=algo,
                                        wire=wire, n=n))
            for wire in (None, "int8"):
                out.append(dict(kind="all_to_all", K=K, seed=seed, wire=wire))
            out.append(dict(kind="reduce_scatter", K=K, seed=seed))
            for tiled in (False, True):
                for dtype in (DTYPES if full else ("float32",)):
                    out.append(dict(kind="all_gather", K=K, seed=seed, tiled=tiled,
                                    dtype=dtype))
    for n in ((5, 13, 30) if full else (13,)):
        for wire in (None, "int8"):
            out.append(dict(kind="chain_all_reduce", n=n, wire=wire))
    chains = CHAINS if L == 8 else [(0, [tuple(range(1, L))])] + (
        [(0, [tuple(range(1, L // 2)), tuple(range(L // 2, L))])] if L >= 4 else [])
    for i, (head, ch) in enumerate(chains):
        for f in frames:
            out.append(dict(kind="broadcast", head=head, chains=ch, frames=f, case=i))
    if L == 8:
        for failed in FAILED:
            for f in frames:
                out.append(dict(kind="degraded", failed=failed, frames=f))
    for c in out:
        c["name"] = "-".join(f"{k}={v}" for k, v in c.items() if k != "chains")
    return out


def global_input(c: dict, L: int) -> np.ndarray:
    k = c["kind"]
    if k == "all_reduce":
        return np.random.default_rng(c["n"] + c["K"]).standard_normal(
            (L, c["n"], 3)).astype(np.float32)
    if k == "chain_all_reduce":
        return np.random.default_rng(c["n"]).standard_normal((L, c["n"])).astype(np.float32)
    if k == "all_to_all":
        return np.random.default_rng(c["K"] * 10 + c["seed"]).standard_normal(
            (L, L, 5)).astype(np.float32)
    if k == "reduce_scatter":
        return np.random.default_rng(c["K"] + c["seed"]).standard_normal(
            (L, L, 6)).astype(np.float32)
    if k == "all_gather":
        return (np.random.default_rng(c["seed"]).standard_normal((L, 4, 3)) * 100).astype(
            DTYPES[c["dtype"]])
    if k == "broadcast":
        return np.random.default_rng(c["case"]).standard_normal((L, 12, 2)).astype(np.float32)
    if k == "degraded":
        return np.random.default_rng(1).standard_normal((L, 6)).astype(np.float32)
    raise ValueError(k)


def _order(L: int, n: int) -> tuple[int, ...]:
    return tuple(int(d) for d in np.random.default_rng(n).permutation(L))


def _call(c: dict, x: torch.Tensor, L: int, group):
    k = c["kind"]
    if k == "all_reduce":
        return cw.multi_chain_all_reduce(x, rings(L, c["K"], c["seed"]), algo=c["algo"],
                                         wire_dtype=c["wire"], group=group)
    if k == "chain_all_reduce":
        return cw.chain_all_reduce(x, _order(L, c["n"]), wire_dtype=c["wire"], group=group)
    if k == "all_to_all":
        return cw.multi_chain_all_to_all(x, rings(L, c["K"], c["seed"]), wire_dtype=c["wire"],
                                         group=group)
    if k == "reduce_scatter":
        return cw.multi_chain_reduce_scatter(x, rings(L, c["K"], c["seed"]), group=group)
    if k == "all_gather":
        return cw.multi_chain_all_gather(x, rings(L, c["K"], c["seed"]), tiled=c["tiled"],
                                         group=group)
    if k == "broadcast":
        if len(c["chains"]) == 1:
            return cw.chain_broadcast(x, (c["head"],) + tuple(c["chains"][0]),
                                      num_frames=c["frames"], group=group)
        return cw.multi_chain_broadcast(x, c["head"], c["chains"], num_frames=c["frames"],
                                        group=group)
    if k == "degraded":
        return cw.degraded_multi_chain_broadcast(x, 0, CHAINS[1][1], c["failed"],
                                                 num_frames=c["frames"], group=group)
    raise ValueError(k)


def run_rank(c: dict, x: torch.Tensor, group) -> torch.Tensor:
    """Rank ``group``-rank's call on its own row ``x``."""
    return _call(c, x, cwd.group_size(group), group)


def run_stacked(c: dict, X: torch.Tensor) -> torch.Tensor:
    """The stacked executor on the whole view."""
    return _call(c, X, X.shape[0], None)


def executor_rank(rank: int, world: int, device: torch.device, case_list: list[dict]) -> dict:
    """Run every case on this rank (the world group) and return
    ``{name: (result, bytes sent, their model, the program byte model)}``
    with results as numpy arrays."""
    group = dist.group.WORLD
    out = {}
    for c in case_list:
        x = torch.from_numpy(global_input(c, world)[rank]).to(device)
        cwd.wire_counter.reset()
        got = run_rank(c, x, group)
        w = cwd.wire_counter
        out[c["name"]] = (got.cpu().numpy(), w.bytes, w.modeled_bytes(), w.program_bytes())
    return out


def executor_mismatches(case_list: list[dict], ranks: list[dict], device) -> list:
    """What the ranks' ``{"cases": executor_rank(...)}`` records
    (``ranks``, in rank order) get wrong against the stacked executor run on ``device``: a rank's
    result not its stacked row bit for bit or its bytes not their model,
    a broadcast whose ranks' bytes do not sum to the members times the
    payload, a ring rank whose bytes are not ``program_wire_bytes``."""
    L, bad = len(ranks), []
    for c in case_list:
        xs = global_input(c, L)
        want = run_stacked(c, torch.from_numpy(xs).to(device))
        got = [r["cases"][c["name"]] for r in ranks]
        for r, (row, sent, model, _) in enumerate(got):
            if not (torch.equal(torch.from_numpy(row).to(device), want[r]) and sent == model):
                bad.append((c["name"], r))
        if c["kind"] == "broadcast":
            members = sum(len(ch) for ch in c["chains"])
            if sum(g[1] for g in got) != members * xs[0].nbytes:
                bad.append((c["name"], "bytes"))
        elif any(g[1] != g[3] for g in got):
            bad.append((c["name"], "ring bytes"))
    return bad


# ---------------------------------------------------------------------------
# The 8-rank world: the executor grid, meshes, and the grad reduction
# ---------------------------------------------------------------------------

# torrent_grad_reduce variants: (knobs, pods); pods=2 is a ("pod", "data")
# mesh of 2 x 4 ranks, reduced within each pod, then across pods
REDUCE_VARIANTS = {
    "exact": ({}, None),
    "k2_rotation": (dict(num_chains=2, algo="rotation"), None),
    "bucketed_k2": (dict(num_chains=2, bucket_bytes=2048), None),
    "int8_ef_k2": (dict(num_chains=2, wire_dtype="int8", error_feedback=True), None),
    "hierarchical": ({}, 2),
    "hierarchical_int8_ef_bucketed": (
        dict(wire_dtype="int8", error_feedback=True, bucket_bytes=2048), 2),
}


def tiny_config(C):
    """The 1-layer model of the JAX package's own grad-reduce test
    (``tests/test_sharding_and_elastic.py``), from either package's
    ``configs`` module."""
    import dataclasses

    return dataclasses.replace(C.get_smoke_config("yi-6b"), num_layers=1, d_model=32,
                               num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=32,
                               head_dim=16)


def _np(tree) -> list[np.ndarray]:
    from repro_torch.tree import leaves

    return [t.detach().cpu().numpy().copy() for t in leaves(tree)]


def ep_rank(rank: int, world: int, moe_np, x_np: np.ndarray) -> dict:
    """The process form of ``moe_apply_ep`` on this rank's bf16 tokens
    ``x_np[rank]`` (deepseek-moe-16b's smoke MoE layer at capacity 8): K
    = 1, K = 2 and the int8 wire, the ``moe_ep_dispatch`` route under a
    ``ProcessMesh``, and this rank's grads of its share of ``mean(o²) +
    aux`` (JAX's loss over every rank: each rank's squares over the
    whole count, plus aux / world)."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import hints
    from repro_torch.tree import leaves, map_tree

    cfg = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), capacity_factor=8.0)
    params = params_from_numpy(moe_np, "cpu")
    x = torch.from_numpy(x_np[rank:rank + 1]).to(torch.bfloat16)  # (1, S, d)
    group = dist.group.WORLD
    out = {}
    for name, kw in (("k1", {}), ("k2", {"num_chains": 2}), ("int8", {"wire_dtype": "int8"})):
        o, a = M.moe_apply_ep(params, x[None], cfg, group=group, **kw)
        out[name] = (o[0].float().numpy(), float(a))
    mesh = make_process_mesh()
    with hints.set_mesh(mesh):
        o, a = M.moe_apply(params, x, dataclasses.replace(cfg, moe_ep_dispatch=True))
    out["auto"] = (o.float().numpy(), float(a))
    ps = map_tree(lambda t: t.detach().requires_grad_(True), params)
    o, a = M.moe_apply_ep(ps, x[None], cfg, group=group)
    loss = (o.float() ** 2).sum() / (world * o.numel()) + a / world
    out["grads"] = [g.numpy() for g in torch.autograd.grad(loss, leaves(ps))]
    return out


def world8_rank(rank: int, world: int, device: torch.device, case_list: list[dict],
                params_np, batch_np: dict, moe_np, moe_x: np.ndarray) -> dict:
    """Every case of the 8-rank world on this rank: the executor grid,
    the meshes' groups, ``MultiChainPlan.broadcast`` over a group,
    ``torrent_grad_reduce`` in each of :data:`REDUCE_VARIANTS`, and the
    process form of expert parallelism (:func:`ep_rank`)."""
    from repro_torch import configs as C
    from repro_torch.core.topology import MeshTopology
    from repro_torch.data.pipeline import rank_slice
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel.collectives import (
        MultiChainPlan, ef_residual_init, torrent_grad_reduce)

    out = {"executor": executor_rank(rank, world, device, case_list)}
    meshes = {None: make_process_mesh(), 2: make_process_mesh(pod=2)}
    pm = meshes[2]
    out["mesh"] = {
        "coords": pm.coords, "shape": pm.shape,
        "data_group": (cwd.group_rank(pm.group("data")), cwd.group_size(pm.group("data"))),
        "pod_group": (cwd.group_rank(pm.group("pod")), cwd.group_size(pm.group("pod"))),
        "dp_group": (cwd.group_rank(pm.group(("pod", "data"))),
                     cwd.group_size(pm.group(("pod", "data")))),
    }
    tpm = make_process_mesh(pod=2, model=2)  # a (data=2, model=2) mesh in each pod
    out["mesh"]["tp"] = {
        "coords": tpm.coords, "dp_index": tpm.dp_index,
        "model_group": (cwd.group_rank(tpm.group("model")), cwd.group_size(tpm.group("model"))),
        "data_group": (cwd.group_rank(tpm.group("data")), cwd.group_size(tpm.group("data"))),
    }

    plan = MultiChainPlan(MeshTopology(2, 4), 0, [1, 2, 5, 6, 7], num_chains=2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32))
    out["plan"] = [plan.broadcast(x[rank], num_frames=2, group=dist.group.WORLD).numpy()]
    plan.reform((1, 2, 5, 6, 7))
    out["plan"].append(plan.broadcast(x[rank], group=dist.group.WORLD).numpy())

    cfg = tiny_config(C)
    params = params_from_numpy(params_np, device)
    rows = rank_slice(next(iter(batch_np.values())).shape[0], world, rank)
    local = {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
             for k, v in batch_np.items()}
    grad_fn = make_grad_fn(cfg, loss_chunks=1)
    out["raw"] = _np(grad_fn(params, local)[0])
    out["reduce"] = {}
    for name, (knobs, pods) in REDUCE_VARIANTS.items():
        wrapped = torrent_grad_reduce(grad_fn, meshes[pods], scheduler="tsp", **knobs)
        cwd.wire_counter.reset()
        rec = {}
        if knobs.get("error_feedback"):
            residual = ef_residual_init(params, 1)
            grads, metrics, residual = wrapped(params, local, residual)
            rec["bytes"] = (cwd.wire_counter.bytes, cwd.wire_counter.modeled_bytes(),
                            cwd.wire_counter.program_bytes())
            rec["grads"], rec["residual"] = _np(grads), _np(residual)
            grads, _, residual = wrapped(params, local, residual)
            rec["grads2"], rec["residual2"] = _np(grads), _np(residual)
        else:
            grads, metrics = wrapped(params, local)
            rec["bytes"] = (cwd.wire_counter.bytes, cwd.wire_counter.modeled_bytes(),
                            cwd.wire_counter.program_bytes())
            rec["grads"] = _np(grads)
        rec["loss"] = float(metrics["loss"])
        out["reduce"][name] = rec
    out["ep"] = ep_rank(rank, world, moe_np, moe_x)
    return out


# ---------------------------------------------------------------------------
# The 4-rank world: the train step, the Trainer and checkpoints
# ---------------------------------------------------------------------------

TRAINER = dict(arch="yi-6b", smoke=True, steps=6, global_batch=8, seq_len=32, peak_lr=2e-3,
               warmup_steps=3, ckpt_every=100, loss_chunks=2, log_every=100,
               collectives="torrent")
# a first AdamW step linear in the grads (eps = 1), for comparing updates
LINEAR_ADAMW = dict(peak_lr=1e-2, warmup_steps=1, eps=1.0)


def world4_rank(rank: int, world: int, device: torch.device, params_np, root: str,
                batch_np: dict, moe_np) -> dict:
    """This rank of the process form: the ``Trainer`` (exact, and int8 +
    EF) from carried params, a stacked-form checkpoint restored into its
    rows, one microbatched train step, the spans of a Torrent and of an
    xla step, the ``Trainer`` with ``collectives="xla"``, and one
    expert-parallel train step of the smoke deepseek-moe-16b model from
    ``moe_np``; AdamW's moments are ZeRO-1 blocks over ``data``."""
    import dataclasses
    import os

    from repro_torch import configs as C
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import rank_slice
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.collectives import ef_residual_init
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves as _leaves

    out = {}
    for name, compress in (("exact", False), ("int8", True)):
        tr = Trainer(TrainConfig(ckpt_dir=os.path.join(root, f"proc_{name}"),
                                 compress_grads=compress, **TRAINER),
                     device=device, params=params_np)
        res = tr.run()
        out[name] = {"losses": res["losses"], "rows": (tr.rows.start, tr.rows.stop),
                     "params": _np(tr.state["params"]),
                     "ef": _np(tr.state["ef"]) if compress else None}

    mesh = make_process_mesh()
    cfg = C.get_smoke_config("yi-6b")
    params = params_from_numpy(params_np, device)
    like = {"params": params, "opt": adamw.init(params), "ef": ef_residual_init(params, 1)}
    ckpt = CheckpointManager(os.path.join(root, "stacked"), group=mesh.group("data"))
    got = ckpt.restore(ckpt.latest_step(), like)
    ckpt.close()
    out["restored"] = {"params": _np(got["params"]), "ef": _np(got["ef"]),
                       "step": int(got["opt"]["step"])}

    local = {k: torch.from_numpy(np.ascontiguousarray(v[rank_slice(8, world, rank)])).to(device)
             for k, v in batch_np.items()}
    # the process form's moments are this rank's ZeRO-1 blocks over data
    ospecs = shd.train_state_specs(cfg, mesh)["opt"]
    step = make_train_step(cfg, adamw.OptConfig(**LINEAR_ADAMW), collectives="torrent",
                           mesh=mesh, loss_chunks=2, microbatches=2)
    new_p, _, m = step(params_from_numpy(params_np, device),
                       adamw.init(params, specs=ospecs, mesh=mesh), local)
    out["microbatched"] = {"params": _np(new_p), "loss": float(m["loss"])}

    for collectives in ("torrent", "xla"):
        spans = Spans()
        step = make_train_step(cfg, adamw.OptConfig(), collectives=collectives, mesh=mesh,
                               loss_chunks=2, spans=spans)
        step(params_from_numpy(params_np, device), adamw.init(params, specs=ospecs, mesh=mesh),
             local)
        out["spans" if collectives == "torrent" else "xla_spans"] = {
            k: len(v) for k, v in spans.read().items()}

    # the Trainer with collectives="xla" (JAX's default): the backend's
    # all-reduce of the ranks' grads
    tr = Trainer(TrainConfig(ckpt_dir=os.path.join(root, "proc_xla"),
                             **dict(TRAINER, collectives="xla")),
                 device=device, params=params_np)
    res = tr.run()
    out["xla"] = {"losses": res["losses"], "params": _np(tr.state["params"]),
                  "moment_shapes": [tuple(x.shape) for x in _leaves(tr.state["opt"]["mu"])]}

    # expert parallelism inside the train step, across the processes
    moe = dataclasses.replace(C.get_smoke_config("deepseek-moe-16b"), moe_ep_dispatch=True)
    moe_p = params_from_numpy(moe_np, device)
    spans = Spans()
    step = make_train_step(moe, adamw.OptConfig(**LINEAR_ADAMW), collectives="torrent",
                           mesh=mesh, loss_chunks=2, num_chains=2, spans=spans)
    new_p, _, m = step(moe_p, adamw.init(moe_p, specs=shd.train_state_specs(moe, mesh)["opt"],
                                         mesh=mesh), local)
    out["ep_step"] = {"params": _np(new_p), "loss": float(m["loss"]),
                      "spans": {k: len(v) for k, v in spans.read().items()}}

    # the remat'd recompute exchanges tokens too: run outside the mesh's
    # block (as the autograd engine's thread for a CUDA device sees it),
    # the backward must give the grads of one run inside it
    def ep_grads(inside: bool):
        from repro_torch.models import transformer as T
        from repro_torch.parallel import hints
        from repro_torch.tree import leaves

        ps = params_from_numpy(moe_np, device)
        ls = [t.requires_grad_(True) for t in leaves(ps)]
        with hints.set_mesh(mesh):
            loss, _ = T.loss_fn(ps, moe, local, remat="dots", loss_chunks=2)
            if inside:
                return torch.autograd.grad(loss, ls)
        return torch.autograd.grad(loss, ls)

    out["ep_remat_equal"] = all(torch.equal(a, b) for a, b in zip(ep_grads(False),
                                                                   ep_grads(True)))
    return out


def stalled_rank(rank: int, world: int, device: torch.device) -> None:
    """A mismatched program: rank 1 waits for a broadcast frame that
    rank 0, which runs no program, never sends."""
    if rank == 1:
        cw.chain_broadcast(torch.zeros(4, device=device), (0, 1), group=dist.group.WORLD)


def failing_rank(rank: int, world: int, device: torch.device) -> None:
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")


def rank_of(rank: int, world: int, device: torch.device) -> int:
    return rank
