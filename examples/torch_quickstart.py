"""Quickstart: the Torrent library on PyTorch in five minutes.

The PyTorch twin of ``examples/quickstart.py``, section for section:

1. Schedule a Chainwrite over a mesh NoC and compare against unicast /
   network-layer multicast (the paper's core contribution).
2. Run the four-phase ChainTask orchestration with a real payload, a
   ``uint8`` tensor on the device.
3. Train a tiny LM for a handful of steps with the full framework stack.

Each section returns the numbers it prints. The script runs on the card
and raises without one unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import (
    ChainTask,
    MeshTopology,
    chain_total_hops,
    greedy_schedule,
    multicast_total_hops,
    tsp_schedule,
    unicast_total_hops,
)
from repro_torch.device import resolve_device
from repro_torch.launch.train import TrainConfig, Trainer

# the port's own checkpoint directory: never the JAX example's, so that
# neither package restores the other's checkpoint by accident
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_quickstart_ckpt")


def scheduling_demo() -> dict:
    """Section 1: hop counts of unicast, multicast and two Chainwrite
    schedules from C0 to 12 random nodes of an 8x8 mesh."""
    topo = MeshTopology(8, 8)  # 64-node mesh NoC
    rng = np.random.default_rng(0)
    dests = sorted(rng.choice(np.arange(1, 64), size=12, replace=False).tolist())
    out = {"dests": dests,
           "unicast_hops": unicast_total_hops(topo, dests),
           "multicast_hops": multicast_total_hops(topo, dests),
           "orders": {}, "chain_hops": {}}
    for name, sched in [("greedy", greedy_schedule), ("tsp", tsp_schedule)]:
        order = sched(topo, dests)
        out["orders"][name] = order
        out["chain_hops"][name] = chain_total_hops(topo, order)
    return out


def chaintask_demo(device) -> dict:
    """Section 2: a 64 KiB ``uint8`` payload on ``device`` delivered to
    four clusters of the paper's 20-cluster SoC by a ChainTask."""
    topo = MeshTopology(4, 5)  # the paper's 20-cluster SoC
    # np.arange(64 * 1024, dtype=np.uint8): the counter wrapped to a byte
    payload = (torch.arange(64 * 1024, dtype=torch.int32, device=device) % 256).to(torch.uint8)
    task = ChainTask(topo, source=0, destinations=[3, 7, 12, 18], payload=payload,
                     scheduler="tsp")
    buffers = task.run()
    return {"delivered": sorted(buffers),
            "intact": all(torch.equal(buf, payload) for buf in buffers.values()),
            "cycles": dict(task.cycle_ledger),
            "speedup_vs_unicast": task.speedup_vs_unicast()}


def training_config(ckpt_dir: str = CKPT_DIR) -> TrainConfig:
    """Section 3's TrainConfig: the JAX example's, field for field, but
    for the checkpoint directory."""
    return TrainConfig(arch="yi-6b", smoke=True, steps=20, global_batch=4,
                       seq_len=32, peak_lr=2e-3, warmup_steps=4,
                       ckpt_dir=ckpt_dir, ckpt_every=10,
                       loss_chunks=2, log_every=5)


def training_demo(device, tc: TrainConfig | None = None, params=None) -> dict:
    """Section 3: a ``Trainer`` run of ``tc`` (default
    :func:`training_config`) on ``device``, from ``params`` if given."""
    return Trainer(tc or training_config(), device=device, params=params).run()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    print("=== 1. Chainwrite scheduling (paper Alg. 1 + TSP) ===")
    s = scheduling_demo()
    print(f"source C0 -> {len(s['dests'])} destinations: {s['dests']}")
    print(f"  unicast   total hops: {s['unicast_hops']}")
    print(f"  multicast total hops: {s['multicast_hops']}")
    for name, order in s["orders"].items():
        print(f"  chainwrite[{name}] hops: {s['chain_hops'][name]}"
              f"  (order {order})")

    print("\n=== 2. Four-phase ChainTask (paper Fig. 4) ===")
    c = chaintask_demo(device)
    print(f"  delivered to {c['delivered']} intact={c['intact']}")
    print(f"  cycles: {c['cycles']}")
    print(f"  speedup vs unicast: {c['speedup_vs_unicast']:.2f}x")

    print("\n=== 3. Tiny LM training through the framework ===")
    t = training_demo(device)
    print(f"  loss {t['first_loss']:.3f} -> {t['last_loss']:.3f} "
          f"in {t['final_step']} steps ({t['tokens_per_s']:.0f} tok/s)")
    return {"scheduling": s, "chaintask": c, "training": t}


if __name__ == "__main__":
    main()
