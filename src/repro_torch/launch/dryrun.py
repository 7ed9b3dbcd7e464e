"""Multi-pod dry run: one rank's view of every (arch × shape × mesh)
cell at full width, counted op by op — the port of
``repro.launch.dryrun``.

JAX fakes 512 host devices and lowers and compiles each cell's
per-device SPMD module. Here the cell is built on meta tensors
(``launch.steps.build_cell``: nothing allocated) over a fake
``torch.distributed`` world (the ``fake`` testing backend: collectives
and sends move nothing) of 256 ranks (``--mesh single``, ``(data,
model) = (16, 16)``) or 512 (``--mesh multi``, ``(2, 16, 16)``), and
rank 0 runs one step under :class:`~repro_torch.launch.op_cost.OpCost`.
CUDA is never initialised. For each cell the record holds:

* proof the distribution config is coherent (the step runs),
* ``memory_analysis`` — per-rank bytes from the op counter's live-bytes
  tracker (the keys of JAX's ``_mem_dict``),
* ``roofline`` — ``launch.roofline.extract`` on ``H100_SXM``: counted
  FLOPs, device-memory bytes and per-kind collective wire bytes,
* ``model_flops_global`` and ``useful_flops_ratio``.

The record's keys are JAX's, renamed where the step differs:
``lower_s`` is ``build_s`` (``build_cell``), ``compile_s`` is ``run_s``
(the counted step), ``hlo_flops_global`` is ``counted_flops_global`` and
``hlo_overlap`` is ``op_overlap`` (``launch.op_breakdown.overlap_stats``
on the op trace). ``cuda_initialized`` records that the run never
touched a card.

One cell per process: ``python -m repro_torch.launch.dryrun --arch
llama3-8b --shape train_4k --mesh single`` runs one cell; ``--all``
spawns one subprocess a cell, one after another. Results land
in ``experiments/dryrun_torch/<mesh>/<arch>__<shape><suffix>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

MESH_WORLD = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A ``torch.distributed`` world of ``world`` ranks on the ``fake``
    testing backend, this process rank ``rank``; destroyed on the way
    out (so a later world in the same process still starts)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), world_size=world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             collectives: str = "xla", remat: str = "dots",
             variant: str = "baseline", num_chains: int | str = 1,
             ar_algo: str = "rs_ag", compress_grads: bool = False,
             bucket_bytes: int | None = None,
             topology: str | None = None,
             src_read_bw: int | None = None,
             overlap: bool = False, *, mesh=None, smoke: bool = False) -> dict:
    """One cell's record on the initialised (fake) world: ``mesh`` is
    the production mesh of ``mesh_kind`` unless given (a test's small
    mesh); ``smoke`` builds the smoke config."""
    import torch

    from repro_torch import configs as C
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_breakdown import overlap_stats
    from repro_torch.launch.op_cost import OpCost

    ok, reason = C.applicable(arch, shape_name)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "collectives": collectives, "remat": remat, "variant": variant,
        "num_chains": num_chains, "ar_algo": ar_algo,
        "compress_grads": compress_grads, "bucket_bytes": bucket_bytes,
        "topology": topology, "src_read_bw": src_read_bw,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    cell, seq_shard = build_rank_cell(
        arch, shape_name, mesh, collectives=collectives, num_chains=num_chains,
        ar_algo=ar_algo, remat=remat, variant=variant, compress_grads=compress_grads,
        bucket_bytes=bucket_bytes, topology=topology, smoke=smoke)
    rec["attn_seq_shard"] = seq_shard  # heads the TP size does not divide
    rec["num_chains"] = cell.num_chains  # effective K (VARIANTS resolved)
    rec["ar_algo"] = cell.ar_algo
    rec["compress_grads"] = cell.compress_grads
    rec["bucket_bytes"] = cell.bucket_bytes
    rec["topology"] = cell.topology
    t1 = time.time()
    counter = OpCost()
    counter.run(cell.step_fn, *cell.args)
    t2 = time.time()

    roof = R.extract(counter)
    cfg = cell.cfg
    n_active = _active_params(arch, cfg)
    tokens = (
        cell.shape.global_batch * cell.shape.seq_len
        if cell.shape.kind in ("train", "prefill")
        else cell.shape.global_batch
    )
    mf = R.model_flops(n_active, tokens, cell.shape.kind)
    chips = 1
    for s in mesh.shape.values():
        chips *= s
    flops_global = roof.flops * chips

    rec.update(
        status="ok",
        build_s=round(t1 - t0, 2),
        run_s=round(t2 - t1, 2),
        chips=chips,
        ops=len(counter.records),
        memory_analysis=_mem_dict(counter.memory_analysis()),
        roofline=roof.as_dict(),
        model_flops_global=mf,
        counted_flops_global=flops_global,
        useful_flops_ratio=(mf / flops_global) if flops_global else None,
        constant_bytes=counter.constant_bytes,
        cuda_initialized=torch.cuda.is_initialized(),
    )
    if overlap:
        # modeled bucketed-overlap timeline + the op trace's async and
        # interleaving counts; prices the inner "data"-axis ring stage
        from repro_torch.models import transformer as T
        from repro_torch.tree import leaves

        params = leaves(T.model_init(torch.Generator().manual_seed(0), cfg, device="meta"))
        bb = cell.bucket_bytes or (4 << 20)
        rec["overlap_model"] = R.modeled_train_overlap(
            params,
            int(mesh.shape["data"]),
            max(1, tokens // chips),
            bucket_bytes=bb,
            num_chains=cell.num_chains,
            algo=cell.ar_algo,
            wire_dtype="int8" if cell.compress_grads else None,
            topology=cell.topology,
            src_read_bw=src_read_bw,
        )
        rec["op_overlap"] = overlap_stats(counter.trace)
    return rec


def build_rank_cell(arch: str, shape_name: str, mesh, **kw):
    """``(cell, seq_shard)``: ``steps.build_cell``'s cell on ``mesh``,
    or, where the mesh's TP size does not divide the heads (which JAX's
    GSPMD pads), the cell with ``attn_seq_shard`` (the port's only form
    of that attention) and ``seq_shard`` True."""
    from repro_torch.launch.steps import build_cell

    try:
        return build_cell(arch, shape_name, mesh, **kw), False
    except NotImplementedError as e:
        if "attn_seq_shard" not in str(e):
            raise
    return build_cell(arch, shape_name, mesh, cfg_overrides={"attn_seq_shard": True}, **kw), True


def _active_params(arch: str, cfg, total: int | None = None) -> int:
    """Active (per-token) parameter count — MoE counts top-k+shared.
    ``total`` (all of ``cfg``'s params) is counted from ``model_init`` on
    the meta device unless the caller has it."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves

    if total is None:
        params = T.model_init(torch.Generator().manual_seed(0), cfg, device="meta")
        total = sum(x.numel() for x in leaves(params))
    if not cfg.num_experts:
        return total
    # subtract routed-expert params not active per token
    moe_layers = sum(
        1 for i in range(cfg.num_layers) if cfg.layer_spec(i).ffn == "moe"
    )
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    inactive = moe_layers * per_expert * (cfg.num_experts - cfg.moe_top_k)
    return total - inactive


def _mem_dict(mem) -> dict:
    out = {}
    for key in (
        "temp_size_in_bytes",
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "alias_size_in_bytes",
        "generated_code_size_in_bytes",
        "peak_memory_in_bytes",
    ):
        val = mem.get(key) if isinstance(mem, dict) else getattr(mem, key, None)
        if val is not None:
            out[key] = int(val)
    if not out:
        out["repr"] = str(mem)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", choices=("single", "multi"), default="single")
    p.add_argument("--collectives", choices=("xla", "torrent"), default="xla")
    p.add_argument("--remat", default="dots")
    p.add_argument("--variant", default="baseline",
                   help="optimization bundle from steps.VARIANTS")
    p.add_argument("--num-chains", type=_parse_num_chains, default=1,
                   help="multi-chain Chainwrite sub-rings per DP "
                        "reduction (with --collectives torrent), or "
                        "'auto' to pick K from the all_reduce_latency "
                        "model")
    from repro_torch.core.chainwrite_ref import ALL_REDUCE_ALGOS

    p.add_argument("--ar-algo", choices=ALL_REDUCE_ALGOS, default="rs_ag",
                   help="multi-ring all-reduce schedule: fused "
                        "reduce-scatter/all-gather or full-payload rotation")
    p.add_argument("--compress-grads", action="store_true", default=False,
                   help="int8 wire for the DP gradient all-reduce "
                        "(requires --collectives torrent)")
    p.add_argument("--bucket-mb", type=float, default=None,
                   help="bucket size (MiB) for the bucketed DP grad reduce "
                        "(requires --collectives torrent)")
    p.add_argument("--topology", default=None,
                   help="tiered link-graph spec for auto-K ring planning "
                        "(requires --collectives torrent), e.g. 'pods=2'")
    p.add_argument("--src-read-bw", type=int, default=None,
                   help="source HBM read bandwidth (bytes/cc) for the "
                        "modeled overlap timeline")
    p.add_argument("--overlap", action="store_true", default=False,
                   help="emit the modeled bucketed-overlap timeline "
                        "(roofline.modeled_train_overlap) and the op "
                        "trace's async/interleaving counts in the record")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--all", action="store_true")
    p.add_argument("--meshes", default="single,multi")
    p.add_argument("--timeout", type=int, default=3000)
    args = p.parse_args(argv)

    if args.all:
        from repro_torch import configs as C

        t0 = time.time()
        failures = []
        for mesh_kind in args.meshes.split(","):
            for arch in C.ARCHS:
                for shape in C.SHAPES:
                    rc = _run_subprocess(arch, shape, mesh_kind, args)
                    if rc != 0:
                        failures.append((mesh_kind, arch, shape))
        print(f"sweep: {time.time() - t0:.1f}s wall")
        if failures:
            print("FAILED CELLS:", failures)
            sys.exit(1)
        print("ALL CELLS OK")
        return

    out_dir = os.path.join(args.out, args.mesh)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{args.arch}__{args.shape}{_cell_suffix(args)}.json"
    )
    try:
        with fake_world(MESH_WORLD[args.mesh]):
            rec = run_cell(
                args.arch, args.shape, args.mesh, out_dir,
                collectives=args.collectives, remat=args.remat,
                variant=args.variant, num_chains=args.num_chains,
                ar_algo=args.ar_algo, compress_grads=args.compress_grads,
                bucket_bytes=(
                    int(args.bucket_mb * (1 << 20)) if args.bucket_mb else None
                ),
                topology=args.topology,
                src_read_bw=args.src_read_bw,
                overlap=args.overlap,
            )
    except Exception:
        rec = {
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "status": "error", "traceback": traceback.format_exc(),
        }
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        print(rec["traceback"], file=sys.stderr)
        sys.exit(1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    if rec["status"] == "ok":
        print(
            f"{args.arch} × {args.shape} × {args.mesh}: OK "
            f"run={rec['run_s']}s dominant={rec['roofline']['dominant']}"
        )
    else:
        print(f"{args.arch} × {args.shape} × {args.mesh}: {rec['status']} "
              f"({rec.get('reason', '')})")


def _parse_num_chains(value: str):
    """CLI type for --num-chains: a positive int or the literal 'auto'."""
    if value == "auto":
        return "auto"
    k = int(value)
    if k < 1:
        raise argparse.ArgumentTypeError("num-chains must be >= 1 or 'auto'")
    return k


def _cell_suffix(args) -> str:
    """Output-file suffix encoding every non-default cell knob — shared
    by the single-cell writer and the --all cache check so sweeps over
    different knobs never collide on (or get skipped for) one path."""
    suffix = "" if args.collectives == "xla" else f"__{args.collectives}"
    if args.num_chains != 1:
        suffix += f"__k{args.num_chains}"
    if args.ar_algo != "rs_ag":
        suffix += f"__{args.ar_algo}"
    if args.compress_grads:
        suffix += "__int8"
    mb = getattr(args, "bucket_mb", 0)
    if mb:
        suffix += f"__b{int(mb) if mb == int(mb) else mb}MB"
    topo = getattr(args, "topology", None)
    if topo:
        # spec strings contain ':'/'('/')' — sanitize for filenames
        safe = "".join(c if c.isalnum() or c in "x=." else "-" for c in topo)
        suffix += f"__topo-{safe}"
    srbw = getattr(args, "src_read_bw", None)
    if srbw:
        suffix += f"__srbw{srbw}"
    if args.variant != "baseline":
        suffix += f"__{args.variant}"
    if args.remat != "dots":
        suffix += f"__remat-{args.remat}"
    return suffix


def _run_subprocess(arch: str, shape: str, mesh_kind: str, args) -> int:
    out_dir = os.path.join(args.out, mesh_kind)
    path = os.path.join(out_dir, f"{arch}__{shape}{_cell_suffix(args)}.json")
    if os.path.exists(path):
        with open(path) as f:
            if json.load(f).get("status") in ("ok", "skipped"):
                print(f"skip (cached): {path}")
                return 0
    cmd = [
        sys.executable, "-m", "repro_torch.launch.dryrun",
        "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
        "--collectives", args.collectives, "--remat", args.remat,
        "--num-chains", str(args.num_chains), "--ar-algo", args.ar_algo,
        "--variant", args.variant, "--out", args.out,
    ]
    if args.compress_grads:
        cmd.append("--compress-grads")
    if args.bucket_mb:
        cmd += ["--bucket-mb", str(args.bucket_mb)]
    if getattr(args, "topology", None):
        cmd += ["--topology", args.topology]
    if getattr(args, "src_read_bw", None):
        cmd += ["--src-read-bw", str(args.src_read_bw)]
    if args.overlap:
        cmd.append("--overlap")
    print("::", " ".join(cmd[3:]), flush=True)
    try:
        r = subprocess.run(cmd, timeout=args.timeout)
        return r.returncode
    except subprocess.TimeoutExpired:
        print(f"TIMEOUT: {arch} {shape} {mesh_kind}")
        return 124


if __name__ == "__main__":
    main()
