#!/usr/bin/env python3
"""Whether NCCL runs two ranks on one NVIDIA card.

    python3 scripts/nccl_one_card.py

Spawns two processes on ``cuda:0`` joined in one NCCL process group
(``repro_torch.launch.dist.spawn``, a 120 s timeout) and all-reduces one
tensor. NCCL refuses a world whose ranks share a device, which is why
the process form on a one-card machine (``chip_smoke.py``'s dist phase)
runs gloo and stages its frames through pinned host memory. Prints the
card's name and power limit, then one line ``nccl one card {...}``:
whether the all-reduce ran and, if not, the error the ranks raised.
Exits 0 either way: the script reports, it does not check.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rank(rank, world, device):
    import torch
    import torch.distributed as dist

    x = torch.ones(4, device=device)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return x.tolist()


def main() -> int:
    import torch
    from repro_torch.launch.dist import spawn

    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    try:
        out = {"ran": True, "result": spawn(rank, 2, backend="nccl", device="cuda:0",
                                            timeout_s=120)}
    except Exception as e:  # the refusal is what this script reports
        out = {"ran": False, "error": f"{type(e).__name__}: {e}"[-3000:]}
    print("nccl one card", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
