"""Chainwrite as PyTorch collectives over 8 devices.

The PyTorch twin of ``examples/chainwrite_collectives.py``: P2MP
broadcast to a device *subset*, scheduled ring all-reduce, and the
executor's own count of the bytes it put on the wire — plus the
ChainProgram IR behind all of them: every collective is planned ONCE
(``core.program``) and the same step/edge/byte table drives the
executor, the numpy oracle and the cycle model (section 0 prints the
planned tables).

Run as one process, the 8 devices are the 8 rows of one tensor on the
device (the stacked view, ``core.chainwrite``); under ``torchrun`` each
process is one device and the same collectives run over
``torch.distributed`` (``core.chainwrite_dist``; NCCL on cards, gloo
with ``--device cpu``). The script runs on the card and raises without
one unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_chainwrite_collectives.py
    PYTHONPATH=src torchrun --nproc-per-node 8 \
        examples/torch_chainwrite_collectives.py --device cpu
"""

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core import chainwrite as cw
from repro_torch.core import chainwrite_dist as cwd
from repro_torch.core.scheduling import tsp_schedule
from repro_torch.core.topology import MeshTopology
from repro_torch.device import resolve_device

L = 8  # the devices every section runs over


def show_programs() -> list[str]:
    """--- 0. The schedule IR: one planner, three backends ------------

    Returns each collective's planned step/edge/byte table straight
    from the ChainProgram — the same object `chainwrite` executes,
    `chainwrite_ref` replays and `simulator.program_latency` prices —
    as the lines to print.
    """
    from repro_torch.core import program as prg
    from repro_torch.core.simulator import program_latency
    from repro_torch.core.topology import TieredMeshTopology

    lines = []
    payload = 64 * 1024
    topo = MeshTopology(L, 1)
    # a tiered twin of the same 8-ring: two 4-node pods joined by one
    # 2x-slower link — the crossing counts below price against it
    tiered = TieredMeshTopology(L, 1, pods_x=2, interpod_bw=0.5,
                                interpod_latency=2)
    rings2 = ((0, 1, 2, 3), (4, 5, 6, 7))
    programs = [
        prg.plan_broadcast(L, 0, ((1, 2, 3), (4, 5, 6, 7))),
        prg.plan_all_reduce(L, rings2, "rs_ag"),
        prg.plan_all_reduce(L, rings2, "rotation"),
        prg.plan_reduce_scatter(L, rings2),
        prg.plan_all_gather(L, rings2),
        prg.plan_all_to_all(L, rings2),
    ]
    for prog in programs:
        lines += prog.describe(payload)
        stats = prg.tier_crossing_stats(prog, tiered)
        lines.append(f"  modeled latency: "
                     f"{program_latency(topo, 0, prog, payload)} CC")
        lines.append(f"  inter-pod crossings on {tiered.spec()}: "
                     f"{stats['total']} link(s), per-chain {stats['per_group']}, "
                     f"{stats['crossing_steps']} crossing step(s)\n")

    # Recovery is a program too: two concurrent mid-chain failures of
    # the K=2 broadcast — the detection window plus each re-formed
    # suffix streaming from the member that banked the payload.
    rec = prg.plan_recovery(topo, 0, ((1, 2, 3), (4, 5, 6, 7)), {2, 6})
    lines += rec.describe(payload)
    lines.append(f"  streams from banked members: {rec.group_heads}")
    lines.append(f"  modeled latency (incl. detection): "
                 f"{program_latency(topo, 0, rec, payload)} CC\n")
    return lines


def _payload(device, group) -> torch.Tensor:
    """Device ``d`` holds a (16, 4) f32 block of ``d``: the 8 rows of
    the stacked view, or this rank's own block over ``group``."""
    if group is None:
        return torch.stack([torch.full((16, 4), i, dtype=torch.float32, device=device)
                            for i in range(L)])
    return torch.full((16, 4), dist.get_rank(group), dtype=torch.float32, device=device)


def _per_device(t: torch.Tensor, group) -> torch.Tensor:
    """The (L, ...) stack of every device's ``t``: the stacked view as
    it is, or the ranks' tensors gathered over ``group``."""
    if group is None:
        return t
    out = [torch.empty_like(t) for _ in range(L)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def broadcast_subset(device, group=None) -> dict:
    """--- 1. P2MP broadcast to a subset, frame-pipelined -----------------
    Schedule the chain over the physical 4x2 torus the 8 devices form."""
    topo = MeshTopology(4, 2)
    dests = [3, 5, 6]
    order = (1, *tsp_schedule(topo, dests, source=1))
    y = cw.chain_broadcast(_payload(device, group), order, num_frames=4, group=group)
    means = _per_device(y, group).mean(dim=(1, 2))
    got = {d: float(means[d]) for d in range(L)}
    assert all(got[d] == 1.0 for d in order)
    assert all(got[d] == 0.0 for d in range(L) if d not in order)
    return {"order": order, "means": got}


def ring_all_reduce(device, group=None) -> dict:
    """--- 2. Scheduled ring all-reduce (the DP gradient path) ------------"""
    ring = (0, *tsp_schedule(MeshTopology(L, 1), list(range(1, L)), 0))
    x = _payload(device, group)
    z = _per_device(cw.chain_all_reduce(x, ring, group=group), group)
    xs = _per_device(x, group)
    expect = xs.sum(0)
    torch.testing.assert_close(z, expect.expand_as(z), rtol=1e-7, atol=0)
    return {"ring": ring, "mean": float(z[0].mean()), "expected": float(expect.mean())}


def wire_bytes(device, group=None) -> dict:
    """--- 3. Wire-byte accounting: chain vs native all-reduce ------------
    The bytes one device puts on the wire for the ring all-reduce, from
    the executor's own counter: the stacked view's (each step's permutes
    times a device's frame, as ``program_wire_bytes`` prices them), or
    this rank's sends."""
    ring = (0, *tsp_schedule(MeshTopology(L, 1), list(range(1, L)), 0))
    counter = cw.wire_counter if group is None else cwd.wire_counter
    counter.reset()
    cw.chain_all_reduce(_payload(device, group), ring, group=group)
    payload = 16 * 4 * 4
    return {"bytes_per_device": counter.bytes, "ring_optimum": 2 * (L - 1) / L * payload}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ and not dist.is_initialized()
    group = None
    if launched:
        from repro_torch.launch.dist import init_from_env
        from repro_torch.launch.mesh import make_process_mesh

        device = init_from_env(args.device)
    else:
        device = resolve_device(args.device)
    try:
        if launched:
            if dist.get_world_size() != L:
                raise ValueError(f"this example runs on {L} processes, "
                                 f"not {dist.get_world_size()}")
            group = make_process_mesh().group("data")
        show = group is None or dist.get_rank() == 0
        lines = show_programs()
        b = broadcast_subset(device, group)
        r = ring_all_reduce(device, group)
        w = wire_bytes(device, group)
    finally:
        if launched:
            dist.destroy_process_group()
    if show:
        for line in lines:
            print(line)
        print(f"devices: {L} ({'processes' if group is not None else 'rows of one tensor'} "
              f"on {device.type})")
        print(f"chain order from device 1 over 4x2 torus: {b['order']}")
        print(f"after chain_broadcast(head=1): per-device mean {b['means']}")
        print(f"chain_all_reduce: every device holds mean {r['mean']} "
              f"(expected {r['expected']})")
        print(f"chain all-reduce wire bytes/device: {w['bytes_per_device']:.0f} "
              f"(ring optimum 2*(L-1)/L*payload = {w['ring_optimum']:.0f})")
    return {"programs": lines, "broadcast": b, "all_reduce": r, "wire": w}


if __name__ == "__main__":
    main()
