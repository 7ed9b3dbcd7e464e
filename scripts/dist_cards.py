#!/usr/bin/env python3
"""The process form across cards: one rank per card, over NCCL.

    python3 scripts/dist_cards.py                          # every card (2 or more)
    python3 scripts/dist_cards.py --device cpu --world 4   # the same on the CPU, over gloo

Where ``chip_smoke.py``'s dist phase shares one card between gloo ranks
(NCCL refuses two ranks on a device), this runs each rank on a card of
its own, so the executor hands NCCL the device tensors themselves:

1. ``executor``: the executor's matrix of the dist phase (broadcasts
   with K = 1, 2 and F = 1, 3; rs_ag and rotation all-reduce,
   reduce-scatter, all-gather, all-to-all; exact and int8 wires) on
   ``world`` ranks, each rank's result equal to the stacked executor's
   row bit for bit and its bytes to their model.
2. ``all_reduce``: a chain all-reduce of 256 MiB of f32 a rank (4 MiB
   on the CPU) (rs_ag K = 1 and 2, rotation K = 1, and rs_ag K = 1 on
   the int8 wire), timed over 5 calls (wall, the ranks synchronised
   before each call; median), beside the backend's own
   ``all_reduce`` on the same payload and the bound of the bytes a rank
   sends over one card's NVLink rate (``roofline.H100_SXM.link_bw``).
   Each rank's rs_ag result must equal its row of the stacked
   executor's, run on the first card.
3. ``train``: ``torchrun --nproc-per-node world -m
   repro_torch.launch.train`` (``init_from_env``, the ``ProcessMesh``
   and its groups, the Torrent reduce, int8 + EF, a checkpoint through
   rank 0 and a restart after an injected failure) at smoke size; then
   the same with ``--tp 2`` (a ``(data=world/2, model=2)`` mesh, the
   checkpoint holding the logical leaves), for yi-6b, deepseek-moe-16b
   and mamba2-2.7b (``TRAIN_RUNS``).
4. ``tp`` (4 ranks): tensor parallelism, one rank per card. yi-6b at
   full width and full depth (32 layers) on ``(data=1, model=4)``, then
   at 8 layers on ``(data=2, model=2)`` with the Torrent reduce over
   ``data``; mamba2-2.7b at full width and full depth (64 layers) and
   jamba-v0.1-52b at full width, 5 of 32 layers (its attention layer
   and two MoE layers), on ``(1, 4)``; deepseek-v2-lite-16b (MLA + MoE)
   at 8 of 27 layers on ``(2, 2)`` (``TP_RUNS``; ``--tp-runs`` picks
   some); 4 x 512 tokens a step, 3 steps, through the process-form
   ``Trainer``: losses, step walls and spans (``fwd_bwd``, ``tp_comm``,
   ``reduce``, ``optimizer``), the model group's payload bytes against
   ``parallel.tp.modeled_tp_bytes``, the DP wire bytes against
   ``program_wire_bytes``, a rank's memory (its state, the init's peak,
   the steps' peak) and allocator retries (must be 0); qwen2-vl-7b at
   full width and full depth on ``(1, 4)`` (7 heads a rank). At smoke
   size on the CPU. On cards, then the ``opt-seq`` run
   (``OPT_SEQ_RUNS``): whisper-tiny at full size on ``(1, 4)`` with
   ``attn_seq_shard`` (its 6 heads do not split over 4 ranks, so each
   rank attends for its block of the query rows), through
   ``make_train_step`` on chip_smoke's whisper batch, held against
   TP = 1 on the first card (the first step's f32 grads, 3 bf16 steps'
   losses), a rank's state against the meta count.

5. ``serve_tp`` (4 ranks): tensor-parallel serving, one rank per card,
   ``chip_smoke.tp_serve_traffic`` with 16 decode steps (the admission
   before step 8): jamba-v0.1-52b at full width and full depth (32
   layers) on ``(data=1, model=4)``, deepseek-v2-lite-16b at full depth
   on ``(1, 4)`` and yi-6b at full depth on ``(2, 2)`` (``data`` splits
   the prompts, ``model`` the heads), each rank's shards drawn from
   seed 0 and cut as drawn; and jamba at its first 5 layers on
   ``(1, 4)`` against the TP = 1 run of the same traffic on the first
   card, run first and freed (``SERVE_TP_RUNS``; ``--serve-runs`` picks
   some). No TP = 1 run of jamba's, deepseek-v2-lite's or yi-6b's full
   depth is held beside these runs, so there the
   checks are the ranks': the gathered logits finite and bit-equal
   across each TP group, the greedy tokens equal across it, the model
   group's payload equal to ``modeled_tp_serve_bytes``, no allocator
   retry, and a rank's params taking the bytes their specs give it
   (``predicted_state_gb``, from the meta device). qwen2-vl-7b at full
   depth on ``(1, 4)`` serves the vlm phase's traffic (embeddings at
   image-then-text M-RoPE positions, decoded at one position for every
   row); its f32 params (30.5 GB) and cache fit one card, so it is held
   against TP = 1 on the first card, as the 5-layer jamba run is. Those
   two runs are held as ``chip_smoke.tp_serve_phase`` holds its ranks. On the CPU,
   at smoke size with a 64-token prompt.

6. ``bf16_gap`` (one card, asked for by name): mamba2-2.7b at TP = 1 in
   bf16 compute, all 64 layers, through ``chip_smoke.tp_serve_traffic``
   and replayed from its own prefill cache with the bf16 ``conv`` window
   (and the SSM state) moved by one bf16 step (``BF16_GAP_VARIANTS``):
   the last logits' gap,
   beside TP = 2's 0.358 of the logit scale in bf16.

7. ``long`` (4 ranks, asked for by name): ``long_500k`` on a
   ``ProcessMesh`` across the cards. jamba-v0.1-52b at full width, 5 of
   32 layers (its one attention layer holds 524,288 slots: a rank
   262,144 of them for 4 of the 8 KV heads, 256 MiB a leaf), on
   ``(data=2, model=2)`` through ``chip_smoke.long_rank``: each rank's
   decode from a seeded whole cache at ``chip_smoke.LONG_POSITIONS``
   against the data = 1, TP = 1 decode of the same params and cache on
   its own card, by the long phase's checks. Then the ``moe-ep`` cells
   of ``ep_tp_rank`` over NCCL: deepseek-moe-16b at full
   width, 2 layers, on ``(2, 2)``, held against the same cells on
   ``(2, 1)`` (TP = 1, two cards) routed as that run chose. On the CPU
   at smoke size (jamba's first 5 smoke layers at a 64-slot shape).
   (The EP cells ran in ``chip_smoke.py`` on four gloo ranks sharing one
   card for a while: 75 s there, past that script's time.)

``--parts`` picks parts by name (default: 1-5). Prints the card's name
and power limit, one ``dist cards PART {...}`` line per part, and exits
non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))  # _dist_cases
sys.path.insert(0, str(REPO))  # chip_smoke's serve traffic

# the timed all-reduces: (label, algo, K, wire), each payload's MiB a
# rank on a card and on the CPU, the timed calls, and every spawn's
# timeout
ALL_REDUCES = [("rs_ag_k1", "rs_ag", 1, None), ("rs_ag_k2", "rs_ag", 2, None),
               ("rotation_k1", "rotation", 1, None), ("rs_ag_k1_int8", "rs_ag", 1, "int8")]
MIB = {"card": 256, "cpu": 4}
ITERS = 5
TIMEOUT_S = 300.0


def executor_rank(rank, world, device, case_list):
    import torch.distributed as dist
    import _dist_cases as dc
    from repro_torch.core import chainwrite_dist as cwd

    # an NCCL group's first batch_isend_irecv must be joined by every
    # rank, and a broadcast case leaves some out: one collective first
    dist.barrier()
    return {"transport": cwd.transport(dist.group.WORLD, device),
            "cases": dc.executor_rank(rank, world, device, case_list)}


def all_reduce_rank(rank, world, device, n, iters):
    import numpy as np
    import torch
    import torch.distributed as dist
    import _dist_cases as dc
    from repro_torch.core import chainwrite as cw
    from repro_torch.core import chainwrite_dist as cwd

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    def timed(fn):
        fn()
        walls = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        return float(np.median(walls)) * 1e3, walls

    dist.barrier()
    out = {}
    for label, algo, K, wire in ALL_REDUCES:
        c = dict(kind="all_reduce", K=K, seed=0, algo=algo, wire=wire, n=n)
        x = torch.from_numpy(dc.global_input(c, world)[rank]).to(device)
        rings = dc.rings(world, K, 0)
        cwd.wire_counter.reset()
        got = cw.multi_chain_all_reduce(x, rings, algo=algo, wire_dtype=wire,
                                        group=dist.group.WORLD)
        sent = cwd.wire_counter.bytes
        ms, walls = timed(lambda: cw.multi_chain_all_reduce(
            x, rings, algo=algo, wire_dtype=wire, group=dist.group.WORLD))
        out[label] = {"ms": ms, "walls_s": walls, "sent_bytes": sent,
                      "result": got.cpu().numpy() if label == "rs_ag_k1" else None}
    y = torch.ones((n, 3), dtype=torch.float32, device=device)
    ms, walls = timed(lambda: dist.all_reduce(y))
    out["library"] = {"ms": ms, "walls_s": walls}
    return out


# the tp part's runs: (label, arch, data, model, layers; None = the
# config's); 4 x 512 tokens a step, 3 steps. deepseek-v2-lite-16b's 8 of 27
# layers leave a quarter of the card free at the step peak (its full depth
# at TP = 4 would be ~63 GB of state a rank). "4x1_full_depth" is pure DP
# with ZeRO-1: yi-6b's 6.06 B f32 params whole on every rank, its AdamW
# moments a quarter each (without ZeRO-1 ~97 GB a rank: no card holds it)
TP_RUNS = [("4x1_full_depth", "yi-6b", 4, 1, None),
           ("1x4_full_depth", "yi-6b", 1, 4, None), ("2x2_8_layers", "yi-6b", 2, 2, 8),
           ("mamba2_1x4_full_depth", "mamba2-2.7b", 1, 4, None),
           ("jamba_1x4_5_layers", "jamba-v0.1-52b", 1, 4, 5),
           ("dsv2lite_2x2_8_layers", "deepseek-v2-lite-16b", 2, 2, 8),
           ("qwen2vl_1x4_full_depth", "qwen2-vl-7b", 1, 4, None)]
# the opt-seq runs of the tp part, on cards only: (label, arch, variant),
# on (1, 4) at full depth with chip_smoke's qwen2-vl / whisper batches
# (chip_smoke.tp_fixed_family_setup), each against TP = 1 on the first
# card: whisper-tiny's 6 heads sequence-sharded over 4 ranks
OPT_SEQ_RUNS = [("whisper_opt_seq_1x4_full_depth", "whisper-tiny", "opt-seq")]
TP_TRAIN = dict(steps=3, global_batch=4, seq_len=512, peak_lr=5e-4, warmup_steps=2,
                collectives="torrent", num_chains=1, loss_chunks=8, seed=0)
# the serve_tp part's runs: (label, arch, data, model, layers; None = the
# config's, against_tp1: held against a TP = 1 run on the first card)
SERVE_TP_RUNS = [("jamba_1x4_full_depth", "jamba-v0.1-52b", 1, 4, None, False),
                 ("dsv2lite_1x4_full_depth", "deepseek-v2-lite-16b", 1, 4, None, False),
                 ("yi6b_2x2_full_depth", "yi-6b", 2, 2, None, False),
                 ("jamba_1x4_5_layers", "jamba-v0.1-52b", 1, 4, 5, True),
                 ("qwen2vl_1x4_full_depth", "qwen2-vl-7b", 1, 4, None, True)]
SERVE_TP_STEPS, SERVE_TP_ADMIT = 16, 8
# torchrun at smoke size: (arch, tp)
TRAIN_RUNS = [("yi-6b", 1), ("yi-6b", 2), ("deepseek-moe-16b", 2), ("mamba2-2.7b", 2)]


def bit_checksum(tree) -> int:
    """The sum of every leaf's 32-bit words as integers (exact, on the
    leaf's device, a chunk at a time): equal bits give equal sums."""
    import torch
    from repro_torch.tree import leaves

    total = 0
    for t in leaves(tree):
        words = t.detach().contiguous().view(-1).view(torch.int32)
        for chunk in words.split(1 << 26):
            total += int(chunk.to(torch.int64).sum())
    return total


def state_bytes(cfg, mesh) -> dict:
    """The bytes of a rank's train state on ``mesh`` from the meta device:
    its params as ``param_pspecs`` place them and its AdamW moments as
    ZeRO-1's ``opt_pspecs`` place them, beside the moments whole (the
    same params without ZeRO-1)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.tree import leaves

    specs = shd.train_state_specs(cfg, mesh)
    meta = T.model_init(torch.Generator(), cfg, "meta",
                        place=shd.leaf_placer(specs["params"], mesh))
    opt = adamw.init(meta, specs=specs["opt"], mesh=mesh)

    def size(tree):
        return sum(x.numel() * x.element_size() for x in leaves(tree))

    params = size(meta)
    return {"params": params, "moments": size(opt), "moments_whole": 2 * params + 4,
            "split": sum(p.numel() * p.element_size()
                         for p, m in zip(leaves(meta), leaves(opt["mu"])) if m.shape != p.shape)}


def tp_rank(rank, world, device, arch, tp, layers, smoke):
    """One rank of the tp part: the process-form ``Trainer`` at
    ``tp``, driven 3 steps, with its record. With ``data`` > 1 the
    rank's moments are its ZeRO-1 blocks: its state against the meta
    device's count (``predicted_state_gb``) beside the state without
    ZeRO-1 (``no_zero1_state_gb``, the moments whole) and the peak that
    would take (``no_zero1_step_peak_gb``: the measured step peak over
    the state, added to it), the param gather's bytes a step against
    ``(data - 1) / data`` of the split params', and a checksum of the
    params' bits after the steps."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.train import TrainConfig, Trainer
    from repro_torch.optim import adamw
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans

    cuda = device.type == "cuda"

    def mem(fn):
        return fn() / 1e9 if cuda else None

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0) if cuda else 0
    spans = Spans()
    t0 = time.perf_counter()
    kw = dict(TP_TRAIN, arch=arch, smoke=smoke, layers=layers)
    if smoke:
        kw.update(seq_len=32, layers=None)
    tr = Trainer(TrainConfig(tp=tp, **kw), device=device, spans=spans)
    data = tr.mesh.shape["data"]
    count = state_bytes(tr.cfg, tr.mesh)
    rec = {"mesh": tr.mesh.shape, "layers": tr.cfg.num_layers,
           "init_s": time.perf_counter() - t0,
           "state_memory_gb": mem(torch.cuda.memory_allocated),
           "predicted_state_gb": (count["params"] + count["moments"]) / 1e9,
           "no_zero1_state_gb": (count["params"] + count["moments_whole"]) / 1e9,
           "params_gb": count["params"] / 1e9,
           "init_peak_memory_gb": mem(torch.cuda.max_memory_allocated),
           "transport": cwd.transport(tr.mesh.group("model" if tp > 1 else "data"), device)}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tokens = kw["global_batch"] * kw["seq_len"] // tr.mesh.shape["data"]
    # no model group at TP = 1: no TP payload; the Trainer's batches are
    # token ids, a vlm's too
    model = (tpm.modeled_tp_bytes(tr.cfg, tokens, tp, embeds=False) if tp > 1
             else {"fwd": 0, "bwd": 0})
    losses, walls, span_ms, tp_bytes, wire, gathered = [], [], [], [], [], []
    for i in range(kw["steps"]):
        tpm.tp_counter.reset()
        cwd.wire_counter.reset()
        adamw.gather_counter.reset()
        batch = tr.place(tr.source.batch(i))
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        params, opt, m = tr.step_fn(tr.state["params"], tr.state["opt"], batch)
        tr.state = {"params": params, "opt": opt}
        losses.append(float(m["loss"]))
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        ms = spans.read()
        span_ms.append({k: round(sum(v), 3) if k == "tp_comm" else [round(x, 3) for x in v]
                        for k, v in ms.items()})
        span_ms[-1]["tp_comm_calls"] = len(ms.get("tp_comm", []))
        tp_bytes.append(dict(tpm.tp_counter.bytes))
        wire.append((cwd.wire_counter.bytes, cwd.wire_counter.program_bytes()))
        gathered.append(adamw.gather_counter.bytes)
    gather_count = count["split"] * (data - 1) // data
    peak = mem(torch.cuda.max_memory_allocated)
    rec.update({
                "gather_bytes_per_step": gathered[-1], "gather_bytes_count": gather_count,
                "gather_equal_count": all(b == gather_count for b in gathered),
                "no_zero1_step_peak_gb": (None if peak is None else
                                          peak - rec["predicted_state_gb"]
                                          + rec["no_zero1_state_gb"]),
                "params_checksum": bit_checksum(tr.state["params"]),"losses": losses, "step_wall_s": walls, "median_step_s": float(np.median(walls)),
                "spans_ms": span_ms[-1], "tp_bytes_per_step": tp_bytes[-1],
                "modeled_tp_bytes_per_step": model,
                "tp_bytes_equal_model": all(b == model for b in tp_bytes),
                "dp_wire_bytes_per_step": wire[-1][0],
                "dp_wire_equal_program_bytes": all(a == b for a, b in wire),
                "step_peak_memory_gb": peak,
                "alloc_retries": (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                                  - retries0) if cuda else 0})
    return rec


def serve_traffic(data: int, dp_index: int = 0, smoke: bool = False) -> dict:
    """``chip_smoke``'s serve traffic with ``SERVE_TP_STEPS`` steps; on a
    mesh with ``data`` > 1, DP rank ``dp_index``'s block of the prompts
    (``smoke``: 64-token prompts and a 32-token admission)."""
    import chip_smoke as cs

    n = cs.TP_SERVE_TRAFFIC["B"] // data
    out = dict(cs.TP_SERVE_TRAFFIC, STEPS=SERVE_TP_STEPS, ADMIT=SERVE_TP_ADMIT,
               rows=slice(dp_index * n, (dp_index + 1) * n))
    if smoke:
        out.update(S=64, SLOT_LEN=32)
    return out


def serve_tp_rank(rank, world, device, arch, data, layers, ref_path, smoke):
    """One rank of the serve_tp part: its shards of ``arch`` (cut to
    ``layers``) on a ``(data, model=world/data)`` mesh serve its rows of
    the traffic; with ``ref_path``, fed the TP = 1 run's tokens and
    routed as it routed, and held against it."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import hints
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tp as tpm
    from repro_torch.runtime.spans import Spans
    from repro_torch.tree import leaves

    cuda = device.type == "cuda"
    mesh = make_process_mesh(data=data, model=world // data)
    tp = mesh.shape["model"]
    cfg = cs.tp_serve_config(arch, layers, smoke)
    traffic = serve_traffic(data, mesh.dp_index, smoke)
    specs = shd.logical_pspecs(cfg, tp)
    meta = T.model_init(torch.Generator(), cfg, "meta", place=shd.leaf_placer(specs, mesh))
    predicted = sum(x.numel() * x.element_size() for x in leaves(meta)) / 1e9
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0) if cuda else 0
    t0 = time.perf_counter()
    params = T.model_init(torch.Generator(device=device).manual_seed(cs.TP_SERVE_TRAFFIC["seed"]),
                          cfg, device, place=shd.leaf_placer(specs, mesh))
    rec = {"mesh": mesh.shape, "layers": cfg.num_layers, "init_s": time.perf_counter() - t0,
           "predicted_state_gb": predicted,
           "state_memory_gb": torch.cuda.memory_allocated() / 1e9 if cuda else None,
           "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None}
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ref = torch.load(ref_path, weights_only=False) if ref_path else None
    spans = Spans()
    t0 = time.perf_counter()
    with hints.set_mesh(mesh), tpm.timed(spans):
        if ref is not None:
            from _moe_routing import routing_as

            with routing_as(ref["routing"]) as flips:
                got = cs.tp_serve_traffic(cfg, params, device, reference=ref, traffic=traffic)
            rec["routing_flips"] = int(sum(int(f.sum()) for f in flips))
        else:
            got = cs.tp_serve_traffic(cfg, params, device, traffic=traffic)
    wall = time.perf_counter() - t0
    comm = spans.read().get("tp_comm", [])
    n = cs.TP_SERVE_TRAFFIC["B"] // data
    sizes = {"prefill": (n, traffic["S"]), "decode": (n, 1), "slot": (1, traffic["SLOT_LEN"])}
    # a vlm's traffic has no admission; an admission is its rank's own
    # batch, with no exchange over data
    model = {k: tpm.modeled_tp_serve_bytes(cfg, *sizes[k], tp, dp=data if k != "slot" else 1)
             for k in got["tp_bytes"]}
    logits = {"prefill": got["prefill_logits"].cpu(),
              **{f"final_{k}": v.cpu() for k, v in got["final_logits"].items()}}
    rec.update({"tokens": [t.tolist() for t in got["tokens"]],
                "finite": all(bool(torch.isfinite(v).all()) for v in logits.values()),
                "tp_bytes_equal_model": got["tp_bytes"] == model,
                "tp_bytes": got["tp_bytes"], "modeled_tp_bytes": model,
                "prefill_ms": got["prefill_ms"],
                "decode_step_ms": float(np.median(got["step_ms"])),
                "traffic_wall_s": wall, "tp_comm_ms": sum(comm),
                "tp_comm_share": sum(comm) / 1e3 / wall,
                "step_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                "alloc_retries": (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                                  - retries0) if cuda else 0,
                "logits": logits})
    if ref is not None:
        cache = shd.gather_cache(got["cache"], shd.logical_cache_pspecs(
            cfg, C.SHAPES["decode_32k"], n, cs.TP_SERVE_MAX_SEQ, tp), cfg, mesh)
        want = torch.load(ref_path.replace(".pt", "_cache.pt"), weights_only=False)
        diffs = cs.token_differences(got["tokens"], ref)
        rec.update({
            "tokens_equal_tp1": not diffs,
            "differences": diffs,
            "prefill_logits_rel": cs._rel_rows(logits["prefill"], ref["prefill_logits"]),
            "final_logits_rel": {str(k): cs._rel_rows(v.cpu(), ref["final_logits"][k])
                                 for k, v in got["final_logits"].items()},
            "cache_rel_max": max(float((a.float() - b.to(a.device).float()).abs().max()
                                       / b.float().abs().max().clamp_min(1e-30))
                                 for a, b in zip(leaves(cache), want))})
    return rec


def serve_tp_part(device, world, on_card, labels=None) -> bool:
    """Part 5: tensor-parallel serving, one rank per card (4 ranks);
    with ``labels``, only those of ``SERVE_TP_RUNS``."""
    import torch
    import chip_smoke as cs
    from repro_torch.launch.dist import spawn

    if world != 4:
        print(f"dist cards serve_tp: needs 4 ranks, got {world}", file=sys.stderr)
        return False
    ok = True
    for label, arch, data, model, layers, against_tp1 in SERVE_TP_RUNS:
        if labels and label not in labels:
            continue
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(prefix="serve_tp_") as ref_dir:
                ref_path, tp1 = None, None
                if against_tp1:
                    # the TP = 1 run on the first card, freed before the spawn
                    tp1 = cs.tp_serve_reference(arch, ref_dir, "cuda:0" if on_card else "cpu",
                                                layers, serve_traffic(1, smoke=not on_card),
                                                smoke=not on_card)
                    ref_path = f"{ref_dir}/{arch}.pt"
                ranks = spawn(serve_tp_rank, world, device=device, timeout_s=1200,
                              args=(arch, data, layers, ref_path, not on_card))
        except Exception as e:  # the part fails; the next runs still report
            print(f"dist cards serve_tp {label}", json.dumps({"ok": False, "error": repr(e)[-2000:]}),
                  flush=True)
            ok = False
            continue
        logits = [r.pop("logits") for r in ranks]
        for r, rec in enumerate(ranks):
            print(f"dist cards serve_tp {label} rank {r}", json.dumps(rec), flush=True)
        # the TP ranks of one DP rank: the same logits and tokens
        group = [list(range(i, i + model)) for i in range(0, world, model)]
        same = all(torch.equal(logits[g[0]][k], logits[j][k]) and
                   ranks[g[0]]["tokens"] == ranks[j]["tokens"]
                   for g in group for j in g[1:] for k in logits[g[0]])
        good = (same and all(r["finite"] and r["tp_bytes_equal_model"] and not r["alloc_retries"]
                             and r["mesh"] == {"data": data, "model": model} for r in ranks))
        if on_card:
            good &= all(abs(r["state_memory_gb"] - r["predicted_state_gb"])
                        <= 0.01 * r["predicted_state_gb"] for r in ranks)
        if against_tp1:
            tol = cs.TP_SERVE_DECODE_TOL.get(arch, cs.TP_SERVE_LOGIT_TOL)
            good &= all(all(d["reference_top2_margin_rel"] <= tol for d in r["differences"])
                        and r["prefill_logits_rel"] <= cs.TP_SERVE_LOGIT_TOL
                        and all(v <= tol for v in r["final_logits_rel"].values())
                        and r["cache_rel_max"] <= cs.TP_SERVE_CACHE_TOL for r in ranks)
        ok &= bool(good)
        print(f"dist cards serve_tp {label}", json.dumps({
            "ok": bool(good), "arch": arch, "mesh": {"data": data, "model": model},
            "layers": ranks[0]["layers"], "ranks_agree": same, "tp1_reference": tp1,
            "tokens_equal_tp1": [r.get("tokens_equal_tp1") for r in ranks],
            "prefill_logits_rel": [r.get("prefill_logits_rel") for r in ranks],
            "final_logits_rel": [r.get("final_logits_rel") for r in ranks],
            "cache_rel_max": [r.get("cache_rel_max") for r in ranks],
            "predicted_state_gb": [r["predicted_state_gb"] for r in ranks],
            "state_memory_gb": [r["state_memory_gb"] for r in ranks],
            "init_peak_memory_gb": [r["init_peak_memory_gb"] for r in ranks],
            "step_peak_memory_gb": [r["step_peak_memory_gb"] for r in ranks],
            "prefill_ms": max(r["prefill_ms"] for r in ranks),
            "decode_step_ms": max(r["decode_step_ms"] for r in ranks),
            "tp_comm_share": [r["tp_comm_share"] for r in ranks],
            "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    return ok


# the bf16_gap part: mamba2-2.7b at TP = 1 in bf16 compute, all 64 layers,
# against itself replayed from its prefill cache moved by one bf16 step:
# the bf16 conv window in the share of elements where TP = 2's cache
# differed from TP = 1's (2.66%, measured by chip_smoke.tp_serve_witness),
# then in every element, then with the f32 SSM state also moved by a
# bf16 step (2^-7 of each element, either way); TP = 2 in bf16
# read 0.358 of the logit scale there. (variant: (conv share, ssm share))
BF16_GAP_VARIANTS = {"conv_2.66%": (0.0266, 0.0), "conv_all": (1.0, 0.0),
                     "conv_and_ssm_all": (1.0, 1.0)}


def bf16_step(x, share: float, seed: int):
    """``x`` (bf16) with a ``share`` of its elements (drawn from
    ``seed``) moved to a neighbouring bf16 value, up or down at random:
    one bit of the 16-bit pattern, away from or towards zero."""
    import torch

    gen = torch.Generator(device=x.device).manual_seed(seed)
    pick = torch.rand(x.shape, generator=gen, device=x.device) < share
    sign = torch.randint(0, 2, x.shape, generator=gen, device=x.device, dtype=torch.int16) * 2 - 1
    bits = x.contiguous().view(torch.int16)
    sign = torch.where(bits & 0x7FFF == 0, 1, sign).to(torch.int16)  # ±0: a subnormal, not NaN
    return torch.where(pick, bits + sign, bits).view(torch.bfloat16)


def bf16_gap_part(device, on_card) -> bool:
    """The open mamba2-2.7b bf16 question: ``chip_smoke.tp_serve_traffic``
    at TP = 1 in bf16 (the plain attention; all 64 layers at full width on
    a card, the smoke config on the CPU), then replayed, fed its own
    tokens, from its own prefill cache (the noise floor) and from that
    cache moved by one bf16 step (``BF16_GAP_VARIANTS``): the last
    logits' gap relative to
    the row's scale, beside TP = 2's 0.358. Rounding amplified over depth
    should give a gap of that size."""
    import torch
    import chip_smoke as cs
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, paths, unflatten

    t0 = time.perf_counter()
    arch = "mamba2-2.7b"
    cfg = cs.tp_serve_config(arch, None, not on_card, attn_impl="reference")
    params = T.model_init(torch.Generator(device=device).manual_seed(cs.TP_SERVE_TRAFFIC["seed"]),
                          cfg, device)
    traffic = serve_traffic(1, smoke=not on_card)
    ref = cs.tp_serve_traffic(cfg, params, device, traffic=traffic, keep_prefill_cache=True)
    start = [x.clone() for x in leaves(ref.pop("prefill_cache"))]
    keys = [p[-1] for p, _ in paths(ref["cache"])]
    last = next(iter(ref["final_logits"]))
    want = ref["final_logits"][last].float().cpu()

    def replay(cache_leaves) -> float:
        def edit(cache):
            return unflatten(cache, [x.clone() for x in cache_leaves])

        got = cs.tp_serve_traffic(cfg, params, device, reference=ref, traffic=traffic,
                                  edit_cache=edit)
        return cs._rel_rows(got["final_logits"][last].float().cpu(), want)

    rec = {"arch": arch, "layers": cfg.num_layers, "compute": "bfloat16",
           "own_cache_rel": replay(start), "moved_rel": {}}
    for name, (conv, ssm) in BF16_GAP_VARIANTS.items():
        moved = []
        for i, (k, x) in enumerate(zip(keys, start)):
            if k == "conv":
                x = bf16_step(x, conv, i)
            elif k == "ssm" and ssm:
                gen = torch.Generator(device=x.device).manual_seed(i)
                x = x * (1 + 2.0 ** -7 * (torch.randint(0, 2, x.shape, generator=gen,
                                                        device=x.device) * 2 - 1))
            moved.append(x)
        rec["moved_rel"][name] = replay(moved)
    rec["tp2_bf16_rel"] = 0.358
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    # a replay from its own cache is deterministic: 0
    ok = rec["own_cache_rel"] == 0 and all(math.isfinite(v) for v in rec["moved_rel"].values())
    rec["ok"] = bool(ok)
    print("dist cards bf16_gap", json.dumps(rec), flush=True)
    del params, ref
    return bool(ok)


# the long part's EP under TP: deepseek-moe-16b with the moe-ep variant at
# full width, 2 of 28 layers (one dense, one MoE: 64 routed experts top-6),
# its train and decode cells on (data=2, model=2), one rank a card: data
# rank d owns experts [32d, 32d + 32) and model rank m holds [32m, 32m +
# 32), so ranks (0, 1) and (1, 0) run no expert. Held against the same
# cells on (data=2, model=1) (EP at TP = 1) from the same seeds, routed as
# that run chose. Shapes: the train cell's 8 x 256 tokens, the decode
# cell's 8 rows of a 512-position cache
EP_TP = dict(arch="deepseek-moe-16b", layers=2, steps=3,
             train=("train_ep", "train", 256, 8), decode=("decode_ep", "decode", 512, 8))


def ep_tp_rank(rank, world, device, ref_dir, tp, cfg_kw=None):
    """One rank of the long part's EP cells on ``(data=world/tp, model=tp)``:
    ``EP_TP``'s moe-ep train cell, ``EP_TP["steps"]`` Torrent steps, and
    its decode cell's logits (``decode_step`` on the cell's args under the
    mesh). At ``tp`` = 1 (the reference) it records each MoE call's
    routing to ``ref_dir``; at ``tp`` > 1 it routes as that run's rank of
    its ``data`` coordinate chose. Per step: the loss, the wall, and the
    bytes of the EP exchanges (the all-to-all programs this process ran,
    priced by ``sent_wire_bytes``) against ``modeled_ep_bytes(train=True)``;
    the decode's EP bytes against ``modeled_ep_bytes``; the kernels the
    main path launched."""
    import torch
    import chip_smoke as cs
    from _moe_routing import recorded_routing, routing_as
    from repro_torch import configs as Cfg
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import chainwrite_dist as cwd
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as Tm
    from repro_torch.parallel import hints
    from repro_torch.parallel.tp import modeled_ep_bytes

    kw = dict(EP_TP, **(cfg_kw or {}))
    mesh = make_process_mesh(data=world // tp, model=tp)
    d = mesh.coords["data"]
    on_card = torch.device(device).type == "cuda"

    def ep_bytes():
        return sum(n * cwd.sent_wire_bytes(p, size, frames, r)
                   for (p, size, frames, r), n in cwd.wire_counter.runs.items()
                   if p.collective == "all_to_all")

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"mesh": mesh.shape, "coords": dict(mesh.coords)}
    recording = tp == 1
    routing = [] if recording else torch.load(f"{ref_dir}/routing_{d}.pt", weights_only=False)
    seen = []
    with cs.registered(Cfg.SHAPES, kw["train"][0], Shape(*kw["train"])), \
            cs.registered(Cfg.SHAPES, kw["decode"][0], Shape(*kw["decode"])), \
            cs.cut_depth(kw["arch"], kw["layers"]):
        cell = build_cell(kw["arch"], kw["train"][0], mesh, collectives="torrent",
                          variant="moe-ep", smoke=kw.get("smoke", False), device=device)
        cfg = cell.cfg
        params, opt, batch = cell.args
        rows = batch["tokens"].numel()
        losses, walls, eps, wires = [], [], [], []
        cs.reset_launches()
        ctx = recorded_routing() if recording else routing_as(routing)
        with ctx as got:
            for _ in range(kw["steps"]):
                cwd.wire_counter.reset()
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = cell.step_fn(params, opt, batch)
                losses.append(float(m["loss"]))
                if on_card:
                    torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                eps.append(ep_bytes())
                wires.append((cwd.wire_counter.bytes, cwd.wire_counter.modeled_bytes()))
            del params, opt, batch, cell
            dcell = build_cell(kw["arch"], kw["decode"][0], mesh, variant="moe-ep",
                               smoke=kw.get("smoke", False), device=device)
            cwd.wire_counter.reset()
            with torch.no_grad(), hints.set_mesh(mesh):
                logits, _ = Tm.decode_step(dcell.args[0], dcell.cfg, dcell.args[1],
                                           dcell.args[2], dcell.args[3])
            decode_ep = cwd.wire_counter.bytes
        launches = cs.read_launches()
        seen = got
    if recording:
        torch.save([x.cpu() for x in seen], f"{ref_dir}/routing_{d}.pt")
        flips = 0
    else:
        flips = int(sum(int(f.sum()) for f in seen))
    model_train = modeled_ep_bytes(cfg, rows, world // tp, d, train=True)
    out.update({"layers": cfg.num_layers, "losses": losses, "step_wall_s": walls,
                "ep_bytes_per_step": eps, "modeled_ep_bytes_per_step": model_train,
                "wire_bytes_equal_executor_model": all(a == b for a, b in wires),
                "decode_ep_bytes": decode_ep,
                "modeled_decode_ep_bytes": modeled_ep_bytes(dcell.cfg, dcell.args[1].numel(),
                                                            world // tp, d),
                "decode_logits": logits.float().cpu(), "routing_flips": flips,
                "launches": launches,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else None,
                "alloc_retries": (torch.cuda.memory_stats().get("num_alloc_retries", 0)
                                  if on_card else 0)})
    return out


# the long part: (label, arch, data, model, layers)
LONG_RUNS = [("jamba_2x2_5_layers", "jamba-v0.1-52b", 2, 2, 5)]
LONG_SMOKE_SHAPE = ("long_smoke", "decode", 64, 1)


def long_cards_rank(rank, world, device, arch, model, layers, smoke):
    """One rank of the long part: ``chip_smoke.long_rank`` on ``(data =
    world/model, model)`` (on the CPU at ``LONG_SMOKE_SHAPE``)."""
    import chip_smoke as cs
    from repro_torch import configs as C
    from repro_torch.configs.shapes import Shape

    if not smoke:
        return cs.long_rank(rank, world, device, arch, layers, model=model)
    with cs.registered(C.SHAPES, LONG_SMOKE_SHAPE[0], Shape(*LONG_SMOKE_SHAPE)):
        return cs.long_rank(rank, world, device, arch, layers, LONG_SMOKE_SHAPE[0], True,
                            model=model)


def long_part(device, world, on_card) -> bool:
    """Part 7: long_500k across the cards, then EP under TP over NCCL."""
    import torch
    import chip_smoke as cs
    from repro_torch.launch.dist import spawn

    if world != 4:
        print(f"dist cards long: needs 4 ranks, got {world}", file=sys.stderr)
        return False
    ok = True
    for label, arch, data, model, layers in LONG_RUNS:
        t0 = time.perf_counter()
        recs = spawn(long_cards_rank, world, device=device, timeout_s=1800,
                     args=(arch, model, layers, not on_card))
        good = not any(r["alloc_retries"] for r in recs)
        for p in recs[0]["positions"]:
            per = [r["positions"][p] for r in recs]
            same = all(torch.equal(per[0]["logits"], q["logits"]) for q in per[1:])
            for q in per:
                q.pop("logits")
                differs = q["tokens"] != q["reference_tokens"]
                tol = cs.TP_SERVE_DECODE_TOL.get(arch, cs.TP_SERVE_LOGIT_TOL)
                good &= bool(same and q["combine_bytes_equal_model"]
                             and q["f32_logits_rel"] <= cs.LONG_F32_TOL
                             and q["logits_rel"] <= tol
                             and q["cache_rel_max"] <= cs.TP_SERVE_CACHE_TOL
                             and (not differs or q["reference_top2_margin_rel"] <= tol))
        for r, rec in enumerate(recs):
            print(f"dist cards long {label} rank {r}", json.dumps(rec), flush=True)
        ok &= bool(good)
        print(f"dist cards long {label}", json.dumps({
            "ok": bool(good), "arch": arch, "mesh": {"data": data, "model": model},
            "layers": recs[0]["layers"], "placed_shapes": recs[0]["placed_shapes"],
            "logits_rel": {p: [r["positions"][p]["logits_rel"] for r in recs]
                           for p in recs[0]["positions"]},
            "f32_logits_rel": {p: recs[0]["positions"][p]["f32_logits_rel"]
                               for p in recs[0]["positions"]},
            "decode_step_ms": [r["decode_step_ms"] for r in recs],
            "combine_bytes_model": recs[0]["combine_bytes_model"],
            "peak_memory_gb": [r["peak_memory_gb"] for r in recs],
            "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    t0 = time.perf_counter()
    kw = None if on_card else dict(smoke=True, layers=None, train=("train_ep", "train", 16, 8),
                                   decode=("decode_ep", "decode", 16, 8), steps=2)
    with tempfile.TemporaryDirectory(prefix="ep_tp_") as ref_dir:
        ref = spawn(ep_tp_rank, 2, device=device, timeout_s=1200, args=(ref_dir, 1, kw))
        ranks = spawn(ep_tp_rank, world, device=device, timeout_s=1200, args=(ref_dir, 2, kw))
    good = True
    for r, rec in enumerate(ranks):
        want = ref[rec["coords"]["data"]]
        rec["losses_vs_tp1"] = max(abs(a - b) for a, b in zip(rec["losses"], want["losses"]))
        lg, wl = rec.pop("decode_logits"), want["decode_logits"]
        rec["decode_logits_rel"] = float(((lg - wl).abs().amax(-1)
                                          / wl.abs().amax(-1)).max())
        good &= bool(rec["losses_vs_tp1"] <= cs.TP_MOE_LOSS_TOL
                     and rec["decode_logits_rel"] <= cs.TP_SERVE_LOGIT_TOL
                     and all(b == rec["modeled_ep_bytes_per_step"] > 0
                             for b in rec["ep_bytes_per_step"])
                     and rec["decode_ep_bytes"] == rec["modeled_decode_ep_bytes"] > 0
                     and rec["wire_bytes_equal_executor_model"] and not rec["alloc_retries"])
        print(f"dist cards long ep_tp rank {r}", json.dumps(rec), flush=True)
    ok &= good
    print("dist cards long ep_tp", json.dumps({
        "ok": good, "mesh": ranks[0]["mesh"], "losses": [r["losses"] for r in ranks],
        "reference_losses": [r["losses"] for r in ref],
        "losses_vs_tp1": [r["losses_vs_tp1"] for r in ranks],
        "decode_logits_rel": [r["decode_logits_rel"] for r in ranks],
        "step_wall_s": [r["step_wall_s"] for r in ranks],
        "reference_step_wall_s": [r["step_wall_s"] for r in ref],
        "ep_bytes_per_step": [r["ep_bytes_per_step"][-1] for r in ranks],
        "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
        "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; required with --device cpu)")
    ap.add_argument("--parts", default="executor,all_reduce,train,tp,serve_tp",
                    help="comma-separated parts to run (default: every multi-rank part; "
                         "bf16_gap runs on the first card; long runs only when named)")
    ap.add_argument("--tp-runs", default=None,
                    help="comma-separated labels of TP_RUNS and OPT_SEQ_RUNS for the tp part "
                         "(default: all)")
    ap.add_argument("--serve-runs", default=None,
                    help="comma-separated labels of SERVE_TP_RUNS for the serve_tp part "
                         "(default: all)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    import torch

    on_card = args.device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            print("dist_cards: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()[0])
    world = args.world or (torch.cuda.device_count() if on_card else 0)
    ref_dev = "cuda:0" if on_card else "cpu"
    ok = True
    if "bf16_gap" in parts:  # one card
        ok &= bf16_gap_part(ref_dev, on_card)
        parts.discard("bf16_gap")
    if parts and world < 2:
        print(f"dist_cards: needs 2 or more ranks, got {world}", file=sys.stderr)
        return 1

    if "executor" in parts:
        ok &= executor_part(args.device, world, on_card, ref_dev)
    if "all_reduce" in parts:
        ok &= all_reduce_part(args.device, world, on_card, ref_dev)
    if "train" in parts:
        for arch, tp in TRAIN_RUNS:
            ok &= train_part(args.device, world, arch, tp)
    if "tp" in parts:
        ok &= tp_part(args.device, world, on_card,
                      args.tp_runs.split(",") if args.tp_runs else None)
    if "serve_tp" in parts:
        ok &= serve_tp_part(args.device, world, on_card,
                            args.serve_runs.split(",") if args.serve_runs else None)
    if "long" in parts:
        ok &= long_part(args.device, world, on_card)
    return 0 if ok else 1


def executor_part(device, world, on_card, ref_dev) -> bool:
    """Part 1: the executor's matrix."""
    import torch
    import _dist_cases as dc
    from repro_torch.launch.dist import spawn

    cases = dc.cases(world, Ks=(1, 2), seeds=(0, 1), full=False)
    t0 = time.perf_counter()
    ranks = spawn(executor_rank, world, device=device, timeout_s=TIMEOUT_S,
                  args=(cases,))
    bad = dc.executor_mismatches(cases, ranks, ref_dev)
    transport = sorted({r["transport"] for r in ranks})
    print("dist cards executor", json.dumps({
        "ranks": world, "cases": len(cases), "bit_exact": not bad, "mismatches": bad[:10],
        "transport": transport, "spawn_and_run_s": round(time.perf_counter() - t0, 2)}),
        flush=True)
    return not bad and transport == (["nccl"] if on_card else ["gloo"])


def all_reduce_part(device, world, on_card, ref_dev) -> bool:
    """Part 2: the timed all-reduces."""
    import torch
    import _dist_cases as dc
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.roofline import H100_SXM

    # a rank's payload is (n, 3) f32 (_dist_cases.global_input)
    n = MIB["card" if on_card else "cpu"] * (1 << 20) // 12 // world * world
    ranks = spawn(all_reduce_rank, world, device=device, timeout_s=TIMEOUT_S,
                  args=(n, ITERS))
    c = dict(kind="all_reduce", K=1, seed=0, algo="rs_ag", wire=None, n=n)
    want = dc.run_stacked(c, torch.from_numpy(dc.global_input(c, world)).to(ref_dev))
    exact = all(torch.equal(torch.from_numpy(r["rs_ag_k1"]["result"]).to(ref_dev), want[i])
                for i, r in enumerate(ranks))
    rec = {"ranks": world, "payload_bytes_per_rank": 12 * n, "rs_ag_k1_bit_exact": exact,
           "library_ms": max(r["library"]["ms"] for r in ranks)}
    for label, *_ in ALL_REDUCES:
        sent = max(r[label]["sent_bytes"] for r in ranks)
        rec[label] = {"ms": max(r[label]["ms"] for r in ranks), "sent_bytes_per_rank": sent,
                      "bound_ms": sent / H100_SXM.link_bw * 1e3}
    print("dist cards all_reduce", json.dumps(rec), flush=True)
    return exact


def train_part(device, world, arch: str, tp: int) -> bool:
    """Part 3: the process-form Trainer for ``arch`` under torchrun, at
    ``--tp``."""
    with tempfile.TemporaryDirectory(prefix="dist_cards_") as ckpt:
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
             "--device", device, "--smoke", "--arch", arch, "--steps", "4",
             "--batch", str(2 * world),
             "--seq", "32", "--collectives", "torrent", "--compress-grads", "--fail-at", "2",
             "--ckpt-every", "1", "--ckpt-dir", ckpt, "--tp", str(tp)],
            capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
        log = proc.stdout + proc.stderr
        trained = proc.returncode == 0 and "done: 4 steps (1 restarts)" in log
        print("dist cards train", json.dumps({
            "arch": arch, "ranks": world, "tp": tp, "rc": proc.returncode, "ok": trained,
            "done": [ln for ln in log.splitlines() if ln.startswith("done:")],
            "wall_s": round(time.perf_counter() - t0, 2),
            "tail": None if trained else log[-3000:]}), flush=True)
    return trained


def opt_seq_part(device, world, labels=None) -> bool:
    """The tp part's ``OPT_SEQ_RUNS`` on the cards: TP = 1 on the first
    card (the first step's f32 grads and 3 bf16 steps, freed before the
    spawn), then the 4 ranks (``chip_smoke.tp_fixed_family_rank``): the
    f32 grads against each rank's block of TP = 1's, the bf16 losses
    against TP = 1's, a rank's state against the meta count, its peak,
    spans and payload against ``modeled_tp_bytes``."""
    import chip_smoke as cs
    from repro_torch.launch.dist import spawn

    ok = True
    for label, arch, variant in OPT_SEQ_RUNS:
        if labels and label not in labels:
            continue
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory(prefix="opt_seq_") as ref_dir:
                ref = cs.tp_fixed_family_reference(arch, ref_dir, variant, "cuda:0")
                ranks = spawn(cs.tp_fixed_family_rank, world, device=device, timeout_s=900,
                              args=(arch, ref_dir, variant))
        except Exception as e:  # the part fails; the next parts still report
            print(f"dist cards tp {label}", json.dumps({"ok": False, "error": repr(e)[-2000:]}),
                  flush=True)
            ok = False
            continue
        for r, rec in enumerate(ranks):
            print(f"dist cards tp {label} rank {r}", json.dumps(rec), flush=True)
        checks = [rk["exact"]["grad_check"] for rk in ranks]
        grad_err = max(max(c["err_and_scale"][i][0] for c in checks)
                       / max(max(c["err_and_scale"][i][1] for c in checks), 1e-30)
                       for i in range(checks[0]["leaves"]))
        loss_diff = max(abs(a - b) for a, b in zip(ranks[0]["exact"]["losses"],
                                                   ref["losses"]["exact"]))
        cfg = cs.tp_fixed_family_config(arch, variant)
        count = state_bytes(cfg, types.SimpleNamespace(shape={"data": 1, "model": world},
                                                       coords={"data": 0, "model": 0}))
        predicted = (count["params"] + count["moments"]) / 1e9
        good = (grad_err <= cs.TP_GRAD_F32_TOL and loss_diff <= cs.TP_LOSS_TOL
                and all(rk["exact"]["losses"] == ranks[0]["exact"]["losses"] for rk in ranks)
                and all(rk["exact"]["tp_bytes_equal_model"] for rk in ranks)
                and all(all(rk["exact"]["whole_leaves_bit_equal"]) for rk in ranks)
                and not any(rk["alloc_retries"] for rk in ranks)
                and all(abs(rk["exact"]["state_memory_gb"] - predicted) <= 0.01 * predicted
                        for rk in ranks))
        ok &= bool(good)
        print(f"dist cards tp {label}", json.dumps({
            "ok": bool(good), "arch": arch, "variant": variant,
            "mesh": {"data": 1, "model": world}, "layers": ref["layers"],
            "first_step_f32_grad_max_rel_err": grad_err, "f32_tolerance": cs.TP_GRAD_F32_TOL,
            "losses": ranks[0]["exact"]["losses"], "tp1_losses": ref["losses"]["exact"],
            "max_loss_diff_vs_tp1": loss_diff, "loss_tolerance": cs.TP_LOSS_TOL,
            "predicted_state_gb": predicted,
            "state_memory_gb": [rk["exact"]["state_memory_gb"] for rk in ranks],
            "step_peak_memory_gb": [rk["exact"]["step_peak_memory_gb"] for rk in ranks],
            "tp1_peak_memory_gb": ref["peak_memory_gb"],
            "median_step_s": max(rk["exact"]["median_step_s"] for rk in ranks),
            "tp_bytes_per_step": ranks[0]["exact"]["tp_bytes_per_step"],
            "tp_bytes_equal_model": [rk["exact"]["tp_bytes_equal_model"] for rk in ranks],
            "spans_ms_rank0": ranks[0]["exact"]["spans_ms"],
            "transport": sorted({rk["transport"] for rk in ranks}),
            "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    return ok


def tp_part(device, world, on_card, labels=None) -> bool:
    """Part 4: tensor parallelism, one rank per card (4 ranks); with
    ``labels``, only those of ``TP_RUNS`` and ``OPT_SEQ_RUNS``."""
    import numpy as np
    from repro_torch.launch.dist import spawn

    if world != 4:
        print(f"dist cards tp: needs 4 ranks, got {world}", file=sys.stderr)
        return False
    ok = True
    for label, arch, data, model, layers in TP_RUNS:
        if labels and label not in labels:
            continue
        t0 = time.perf_counter()
        ranks = spawn(tp_rank, world, device=device, timeout_s=900,
                      args=(arch, model, layers, not on_card))
        for r, rec in enumerate(ranks):
            print(f"dist cards tp {label} rank {r}", json.dumps(rec), flush=True)
        losses = ranks[0]["losses"]
        good = (all(np.isfinite(rk["losses"]).all() for rk in ranks)
                and all(rk["mesh"] == {"data": data, "model": model} for rk in ranks)
                and all(rk["tp_bytes_equal_model"] and rk["dp_wire_equal_program_bytes"]
                        and rk["gather_equal_count"] and not rk["alloc_retries"]
                        for rk in ranks)
                # the TP ranks of one DP rank hold the same loss
                and all(ranks[i]["losses"] == ranks[i - i % model]["losses"]
                        for i in range(world))
                # the DP replicas of one TP rank hold the same params (ZeRO-1's gather)
                and all(ranks[i]["params_checksum"] == ranks[i % model]["params_checksum"]
                        for i in range(world)))
        if on_card:
            good &= all(abs(rk["state_memory_gb"] - rk["predicted_state_gb"])
                        <= 0.01 * rk["predicted_state_gb"] for rk in ranks)
        ok &= bool(good)
        print(f"dist cards tp {label}", json.dumps({
            "ok": bool(good), "arch": arch, "mesh": {"data": data, "model": model},
            "layers": ranks[0]["layers"], "losses": losses,
            "median_step_s": max(rk["median_step_s"] for rk in ranks),
            "step_peak_memory_gb": [rk["step_peak_memory_gb"] for rk in ranks],
            "init_peak_memory_gb": [rk["init_peak_memory_gb"] for rk in ranks],
            "state_memory_gb": [rk["state_memory_gb"] for rk in ranks],
            "predicted_state_gb": ranks[0]["predicted_state_gb"],
            "no_zero1_state_gb": ranks[0]["no_zero1_state_gb"],
            "no_zero1_step_peak_gb": [rk["no_zero1_step_peak_gb"] for rk in ranks],
            "params_gb": ranks[0]["params_gb"],
            "gather_bytes_per_step": [rk["gather_bytes_per_step"] for rk in ranks],
            "gather_bytes_count": ranks[0]["gather_bytes_count"],
            "params_checksums": [rk["params_checksum"] for rk in ranks],
            "spans_ms_rank0": ranks[0]["spans_ms"],
            "transport": sorted({rk["transport"] for rk in ranks}),
            "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)
    if on_card:  # chip_smoke's batches and TP = 1 reference live on the card
        ok &= opt_seq_part(device, world, labels)
    return ok


if __name__ == "__main__":
    sys.exit(main())
