"""Hot-spot breakdown of a counted cell — the dry-run 'profiler', the
port of ``repro.launch.hlo_breakdown``.

The JAX tool ranks the compiled module's instructions by their
trip-count-scaled cost; this one ranks the ops that
:class:`~repro_torch.launch.op_cost.OpCost` booked for one rank's step.
Identical records (the same op, first result shape and path, the path's
layer indices dropped) merge, and their count stands where JAX prints
a trip count (``x{count}``): a 32-layer model's per-layer matmul is one
line ``x32``.

    PYTHONPATH=src python -m repro_torch.launch.op_breakdown \\
        --arch deepseek-v2-lite-16b --shape prefill_32k --top 15

It runs on the CPU, on meta tensors over a fake world of 256 ranks (512
with ``--mesh multi``); it needs no card.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

from repro_torch.launch.op_cost import Wait


def breakdown(cost_records) -> tuple[list, dict, dict]:
    """``(items, by_op_bytes, by_op_flops)`` of a counted run
    (``cost_records``: an ``OpCost`` after its run, or its records):
    ``items`` are ``(bytes, flops, count, op, [shape], path)``, one per
    distinct record, its totals over its ``count`` repeats; the dicts
    total bytes and FLOPs by aten op."""
    records = getattr(cost_records, "records", cost_records)
    merged: dict[tuple, list] = {}
    by_op_bytes: dict[str, float] = defaultdict(float)
    by_op_flops: dict[str, float] = defaultdict(float)
    for r in records:
        if not (r.bytes or r.flops):
            continue
        key = (r.op, r.shape, r.path)
        m = merged.get(key)
        if m is None:
            merged[key] = [r.bytes, r.flops, 1]
        else:
            m[0] += r.bytes
            m[1] += r.flops
            m[2] += 1
        by_op_bytes[r.op] += r.bytes
        by_op_flops[r.op] += r.flops
    items = [(b, f, n, op, [shape], path) for (op, shape, path), (b, f, n) in merged.items()]
    return items, dict(by_op_bytes), dict(by_op_flops)


def overlap_stats(trace) -> dict[str, int]:
    """Program-order overlap evidence from the op trace (``OpCost.trace``,
    or the ``OpCost`` itself) — the op side of the bucketed-reduce overlap
    story, with JAX's keys:

    * ``async_start`` / ``async_done`` — async collective pairs: a
      collective (a ``send`` among them) whose ``Work.wait()`` comes
      after at least one other op (an ``isend`` posted before the step's
      ``irecv``, or an ``async_op`` collective waited on later); a wait
      right after its collective is a synchronous call;
    * ``max_in_flight`` — the most async collectives posted and not yet
      waited on at once;
    * ``collectives`` — collective ops in all;
    * ``interleavings`` — collective → compute → collective transitions,
      "compute" being an op with FLOPs.
    """
    trace = list(getattr(trace, "trace", trace))
    # a collective is async where another op lies between it and its wait
    asynchronous, n_ops = set(), 0
    for t in trace:
        if isinstance(t, Wait):
            if n_ops - t.index > 1:
                asynchronous.add(t.index)
        else:
            n_ops += 1
    stats = {
        "async_start": 0, "async_done": 0, "collectives": 0,
        "interleavings": 0, "max_in_flight": 0,
    }
    in_flight = 0
    seen_collective = False
    compute_since = False
    index = -1
    for t in trace:
        if isinstance(t, Wait):
            if t.index in asynchronous:
                stats["async_done"] += 1
                in_flight = max(0, in_flight - 1)
            continue
        index += 1
        if t.kind is not None:
            if index in asynchronous:
                stats["async_start"] += 1
                in_flight += 1
                stats["max_in_flight"] = max(stats["max_in_flight"], in_flight)
            if seen_collective and compute_since:
                stats["interleavings"] += 1
            stats["collectives"] += 1
            seen_collective = True
            compute_since = False
        elif t.flops:
            compute_since = True
    return stats


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--mesh", choices=("single", "multi"), default="single")
    p.add_argument("--variant", default="baseline")
    p.add_argument("--collectives", default="xla")
    p.add_argument("--remat", default="dots")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--by", choices=("bytes", "flops"), default="bytes")
    args = p.parse_args(argv)

    from repro_torch.launch.dryrun import MESH_WORLD, build_rank_cell, fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_cost import OpCost

    with fake_world(MESH_WORLD[args.mesh]):
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
        cell, _ = build_rank_cell(args.arch, args.shape, mesh, variant=args.variant,
                                  collectives=args.collectives, remat=args.remat)
        counter = OpCost()
        counter.run(cell.step_fn, *cell.args)
    items, by_bytes, by_flops = breakdown(counter)

    total_b = sum(by_bytes.values())
    total_f = sum(by_flops.values())
    print(f"== {args.arch} × {args.shape} ({args.variant}) ==")
    print(f"total bytes {total_b:.4g}   total flops {total_f:.4g}")
    print("\n-- by op (bytes) --")
    for op, b in sorted(by_bytes.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {op:25s} {b:10.4g}  ({100 * b / total_b:5.1f}%)")
    key = 0 if args.by == "bytes" else 1
    print(f"\n-- top ops by {args.by} --")
    for it in sorted(items, key=lambda t: -t[key])[: args.top]:
        b, f, count, name, shapes, path = it
        print(f"  {b:10.4g}B {f:10.4g}F x{count:4.0f} {name:38s} "
              f"{shapes} {path[-60:]}")


if __name__ == "__main__":
    main()
