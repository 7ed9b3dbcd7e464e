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
   rank 0 and a restart after an injected failure) at smoke size.

Prints the card's name and power limit, one ``dist cards PART {...}``
line per part, and exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO / "tests"))  # _dist_cases

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; required with --device cpu)")
    args = ap.parse_args()

    import torch
    import _dist_cases as dc
    from repro_torch.launch.dist import spawn
    from repro_torch.launch.roofline import H100_SXM

    on_card = args.device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            print("dist_cards: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()[0])
    world = args.world or (torch.cuda.device_count() if on_card else 0)
    if world < 2:
        print(f"dist_cards: needs 2 or more ranks, got {world}", file=sys.stderr)
        return 1
    ref_dev = "cuda:0" if on_card else "cpu"
    ok = True

    # 1. the executor's matrix
    cases = dc.cases(world, Ks=(1, 2), seeds=(0, 1), full=False)
    t0 = time.perf_counter()
    ranks = spawn(executor_rank, world, device=args.device, timeout_s=TIMEOUT_S,
                  args=(cases,))
    bad = dc.executor_mismatches(cases, ranks, ref_dev)
    transport = sorted({r["transport"] for r in ranks})
    ok &= not bad and transport == (["nccl"] if on_card else ["gloo"])
    print("dist cards executor", json.dumps({
        "ranks": world, "cases": len(cases), "bit_exact": not bad, "mismatches": bad[:10],
        "transport": transport, "spawn_and_run_s": round(time.perf_counter() - t0, 2)}),
        flush=True)

    # 2. the timed all-reduces
    # a rank's payload is (n, 3) f32 (_dist_cases.global_input)
    n = MIB["card" if on_card else "cpu"] * (1 << 20) // 12 // world * world
    ranks = spawn(all_reduce_rank, world, device=args.device, timeout_s=TIMEOUT_S,
                  args=(n, ITERS))
    c = dict(kind="all_reduce", K=1, seed=0, algo="rs_ag", wire=None, n=n)
    want = dc.run_stacked(c, torch.from_numpy(dc.global_input(c, world)).to(ref_dev))
    exact = all(torch.equal(torch.from_numpy(r["rs_ag_k1"]["result"]).to(ref_dev), want[i])
                for i, r in enumerate(ranks))
    ok &= exact
    rec = {"ranks": world, "payload_bytes_per_rank": 12 * n, "rs_ag_k1_bit_exact": exact,
           "library_ms": max(r["library"]["ms"] for r in ranks)}
    for label, *_ in ALL_REDUCES:
        sent = max(r[label]["sent_bytes"] for r in ranks)
        rec[label] = {"ms": max(r[label]["ms"] for r in ranks), "sent_bytes_per_rank": sent,
                      "bound_ms": sent / H100_SXM.link_bw * 1e3}
    print("dist cards all_reduce", json.dumps(rec), flush=True)

    # 3. the process-form Trainer under torchrun
    with tempfile.TemporaryDirectory(prefix="dist_cards_") as ckpt:
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
             "--device", args.device, "--smoke", "--steps", "4", "--batch", str(2 * world),
             "--seq", "32", "--collectives", "torrent", "--compress-grads", "--fail-at", "2",
             "--ckpt-every", "1", "--ckpt-dir", ckpt],
            capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
        log = proc.stdout + proc.stderr
        trained = proc.returncode == 0 and "done: 4 steps (1 restarts)" in log
        ok &= trained
        print("dist cards train", json.dumps({
            "ranks": world, "rc": proc.returncode, "ok": trained,
            "done": [ln for ln in log.splitlines() if ln.startswith("done:")],
            "wall_s": round(time.perf_counter() - t0, 2),
            "tail": None if trained else log[-3000:]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
