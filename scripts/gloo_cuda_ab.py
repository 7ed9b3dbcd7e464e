#!/usr/bin/env python3
"""How a CUDA tensor best travels over gloo between two ranks sharing one
card (NCCL refuses two ranks on a device, so one card runs gloo).

    python3 scripts/gloo_cuda_ab.py

Two gloo ranks on ``cuda:0`` each hold a 1 GiB f32 leaf and its half;
each variant is timed three times (wall, the ranks synchronised before
each call; the least is printed): the all-gather of the halves into the
leaf staged by hand through pageable host memory, through pinned host
memory (whole leaf back, or only the other rank's half), the CUDA
tensors handed to gloo (a list of views, or one tensor), and the
all-reduce of the leaf through pageable host memory or handed to gloo.
Prints the card's name and power limit and one JSON list, a dict a rank.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

N = 1 << 28  # 1 GiB of f32


def rank_fn(rank, world, device):
    import torch
    import torch.distributed as dist

    out = {}
    p = torch.randn(N, device=device)
    blk = N // world
    me = p[rank * blk:(rank + 1) * blk]
    g = dist.group.WORLD

    def timed(name, fn):
        fn()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = min(ts)

    def pageable():
        host = torch.empty(N)
        dist.all_gather_into_tensor(host, me.contiguous().cpu(), group=g)
        p.copy_(host.to(device))

    def pinned(others_only: bool):
        src = torch.empty(blk, pin_memory=True)
        src.copy_(me)
        host = torch.empty(N, pin_memory=True)
        dist.all_gather_into_tensor(host, src, group=g)
        if not others_only:
            p.copy_(host.to(device, non_blocking=True))
            return
        for r in range(world):
            if r != rank:
                p[r * blk:(r + 1) * blk].copy_(host[r * blk:(r + 1) * blk], non_blocking=True)

    def allreduce_pageable():
        h = p.cpu()
        dist.all_reduce(h, group=g)
        p.copy_(h)

    variants = [("gather_pageable", pageable), ("gather_pinned", lambda: pinned(False)),
                ("gather_pinned_others", lambda: pinned(True)),
                ("gather_cuda_list", lambda: dist.all_gather(list(p.chunk(world)), me.clone(),
                                                             group=g)),
                ("gather_cuda_single", lambda: dist.all_gather_into_tensor(p, me.clone(),
                                                                           group=g)),
                ("allreduce_pageable", allreduce_pageable),
                ("allreduce_cuda", lambda: dist.all_reduce(p, group=g))]
    for name, fn in variants:
        timed(name, fn)
    return out


def main() -> int:
    import torch
    from repro_torch.launch.dist import spawn

    if not torch.cuda.is_available():
        print("gloo_cuda_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    print(json.dumps(spawn(rank_fn, 2, backend="gloo", device="cuda", timeout_s=600)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
