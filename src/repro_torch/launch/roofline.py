"""The pure cost model of ``repro.launch.roofline``: model FLOPs, the
backward-segment compute that gates each gradient bucket, and the
modeled step timeline of the bucketed, backward-overlapped DP gradient
reduction.

The JAX module fixes its machine in module constants; here a
:class:`Machine` (peak FLOP/s, HBM bytes/s, link bytes/s) is passed in
and threaded through :func:`noc_cycles`, :func:`bucket_ready_cc` and
:func:`modeled_train_overlap`. :data:`H100_SXM` is the card the port
runs on. The HLO parsing half of the JAX module (``collective_bytes``,
``Roofline``, ``extract``) reads XLA's compiled text and has no
counterpart here; the executor's ``core.chainwrite.wire_counter`` counts
the bytes a step really moved.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import program as prg
from repro_torch.core import simulator as sim
from repro_torch.core.topology import MeshTopology
from repro_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class Machine:
    """Per-device rates: dense peak FLOP/s of the 16-bit training dtype,
    device-memory bytes/s and bytes/s a direction of one link (what the
    cost model reads), and, where known, the dense f32 and TF32 peaks."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    peak_flops_f32: float | None = None
    peak_flops_tf32: float | None = None


# NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit: 989 TFLOP/s
# dense bf16/f16, 67 TFLOP/s f32 on the CUDA cores, 495 TFLOP/s dense
# TF32, 3.35 TB/s HBM3, and NVLink 4 at 450 GB/s a direction.
H100_SXM = Machine(name="NVIDIA H100 80GB HBM3 (SXM5), 700 W", peak_flops=989e12,
                   hbm_bw=3.35e12, link_bw=450e9, peak_flops_f32=67e12,
                   peak_flops_tf32=495e12)


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D training / 2·N·D inference forward (per step, global)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def backward_flops(n_params: int, tokens: int) -> float:
    """Backward-pass FLOPs attributable to ``n_params`` parameters:
    4·N·D of the 6·N·D training total (2·N·D activation grads + 2·N·D
    weight grads; the forward 2·N·D happens before any gradient
    exists, so only the backward share gates bucket readiness)."""
    return 4.0 * n_params * tokens


def noc_cycles(seconds: float, link_bw: int = 64, *, machine: Machine = H100_SXM) -> int:
    """Seconds -> NoC cycles at the modeled clock. The simulator's cycle
    moves ``link_bw`` bytes per link (``SimParams.link_bw``) and the
    machine's link moves ``machine.link_bw`` bytes/s, so one cycle is
    ``link_bw / machine.link_bw`` seconds — the bridge that lets compute
    estimates and ``program_latency`` share one time base."""
    return int(round(seconds * machine.link_bw / link_bw))


def bucket_ready_cc(
    bucket_params: "list[int]",
    tokens: int,
    *,
    machine: Machine = H100_SXM,
    link_bw: int = 64,
) -> list[int]:
    """Per-bucket compute availability times, in NoC cycles, for
    ``core.simulator.overlap_timeline``.

    ``bucket_params[i]`` is the parameter count of bucket i in dispatch
    (reverse-topological) order. Backward produces the LAST parameters'
    gradients first, so bucket i is ready once the backward segments of
    buckets 0..i have run: ready[i] = cumulative
    ``backward_flops(segment) / machine.peak_flops`` — nondecreasing by
    construction. Pass per-device tokens when the comm latencies are
    per-device too."""
    out: list[int] = []
    acc = 0.0
    for n in bucket_params:
        acc += backward_flops(int(n), tokens) / machine.peak_flops
        out.append(noc_cycles(acc, link_bw, machine=machine))
    return out


def modeled_train_overlap(
    leaves,
    axis_size: int,
    tokens: int,
    *,
    bucket_bytes: int,
    machine: Machine = H100_SXM,
    num_chains="auto",
    algo: str = "rs_ag",
    wire_dtype: "str | None" = None,
    scheduler: str = "tsp",
    max_chains: int = 4,
    topology: "str | None" = None,
    src_read_bw: "int | None" = None,
) -> dict:
    """End-to-end modeled step timeline of the bucketed,
    backward-overlapped DP gradient reduction: bucket assembly
    (``parallel.collectives.assign_buckets``), the backward-segment
    compute availability (:func:`bucket_ready_cc` on ``machine``) and
    the chain all-reduce cost model (``core.simulator.program_latency``),
    fed through ``core.simulator.overlap_timeline``.

    ``leaves`` are the gradient leaves (tensors, meta ones will do, in
    tree order); ``axis_size`` the DP ring size; ``tokens`` the
    per-device tokens per step. Each bucket resolves its own (K, rings)
    from its bytes — the ``resolve_ring_chains`` the executor uses — and
    is priced at its chunk-aligned padded payload
    (``bucket_shard_layout``), so the modeled wire bytes equal the
    executor's count for the bucketed step exactly. ``topology`` (a
    ``parse_topology_spec`` string) makes the auto-K planning and the
    pricing tier-aware; ``src_read_bw`` caps the modeled source read
    bandwidth (``SimParams.src_read_bw``).

    Returns ``{"buckets": [...], "timeline": overlap_timeline(...),
    "total_wire_bytes", "serial_cc", "overlap_cc", "efficiency"}``.
    """
    buckets = col.assign_buckets(leaves, bucket_bytes)
    topo = (
        col._ring_topology(axis_size, topology)
        if topology is not None
        else MeshTopology(axis_size, 1)
    )
    params = (
        sim.SimParams(src_read_bw=src_read_bw)
        if src_read_bw is not None
        else sim.DEFAULT_PARAMS
    )
    ready = bucket_ready_cc(
        [sum(math.prod(leaves[i].shape) for i in b.indices) for b in buckets],
        tokens,
        machine=machine,
    )
    recs, comms = [], []
    for b, r in zip(buckets, ready):
        k, rings = col.resolve_ring_chains(
            axis_size, b.num_bytes, num_chains=num_chains,
            scheduler=scheduler, algo=algo, wire_dtype=wire_dtype,
            max_chains=max_chains, topology=topo,
        )
        shards = col.all_reduce_shards(axis_size, k, algo)
        sizes = [math.prod(leaves[i].shape) for i in b.indices]
        _, total_elems = col.bucket_shard_layout(sizes, shards)
        padded_bytes = total_elems * leaves[b.indices[0]].element_size()
        program = prg.plan_all_reduce(axis_size, rings, algo, wire_dtype=wire_dtype)
        comm = sim.program_latency(topo, 0, program, padded_bytes, params)
        wire = program.wire_bytes(padded_bytes)
        comms.append(int(comm))
        recs.append({
            "leaves": len(b.indices), "dtype": b.dtype,
            "bytes": b.num_bytes, "padded_bytes": int(padded_bytes),
            "num_chains": k, "shards": shards, "ready_cc": int(r),
            "comm_cc": int(comm), "wire_bytes": int(wire),
        })
    tl = sim.overlap_timeline(ready, comms)
    return {
        "buckets": recs,
        "timeline": tl,
        "total_wire_bytes": sum(r["wire_bytes"] for r in recs),
        "serial_cc": tl["serial_cc"],
        "overlap_cc": tl["overlap_cc"],
        "efficiency": tl["efficiency"],
    }


__all__ = ["H100_SXM", "Machine", "backward_flops", "bucket_ready_cc", "model_flops",
           "modeled_train_overlap", "noc_cycles"]
