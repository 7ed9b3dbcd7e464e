#!/usr/bin/env python3
"""Serving tokens/s of two checkouts of the PyTorch port, in turns, on
one NVIDIA card.

    python3 scripts/serve_ab.py ROOT_A ROOT_B [--order ABBA] [--arch yi-6b] [--layers 8]

Each turn is a fresh process that puts ``ROOT/src`` first on its path
and drives the serve traffic of ``chip_smoke.py`` (``serve_prompts``,
``SERVE_CONFIG``): a ``Server`` at the arch's full width with the depth
cut to ``--layers``, ``attn_impl="flash"``, random weights from seed 0;
weight multicast and the 384-token prefix registered, one short warm-up
request (it builds and loads the kernels), then the 8 requests of 32
new tokens through ``run()``, ``--runs`` times. Each turn prints one
line ``turn {...}``: the root, and per run its wall seconds, tokens/s,
the seconds the weight refresh at its start took, and the Python GC's
collections and seconds inside it.

Serving is host-bound and its rate varies from machine to machine, so
compare only turns of one call; ``--order ABBA`` interleaves them.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def turn(root: Path, arch: str, layers: int, runs: int) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke  # the traffic; it imports nothing of the port itself

    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.serve import ServeConfig, Server

    if not Path(sys.modules["repro_torch"].__file__).is_relative_to(root):
        raise RuntimeError(f"imported {sys.modules['repro_torch'].__file__}, not {root}")
    cfg = dataclasses.replace(C.get_config(arch), num_layers=layers, attn_impl="flash")
    server = Server(ServeConfig(arch=arch, **chip_smoke.SERVE_CONFIG), device="cuda",
                    model_cfg=cfg)
    prefix, prompts = chip_smoke.serve_prompts(cfg.vocab_size)
    server.broadcast_weights(chunk_bytes=64 << 20)
    server.register_prefix(prefix)
    server.run([server.submit(prompts[-1], 2)])  # warm-up: kernel builds and loads
    torch.cuda.synchronize()

    gc_s, gc_t0 = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(on_gc)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        server.broadcast_weights()  # what run() starts with, timed alone
        torch.cuda.synchronize()
        refresh = time.perf_counter() - t0
        gc.collect()
        gc_s[0], n0 = 0.0, sum(s["collections"] for s in gc.get_stats())
        reqs = [server.submit(p, 32) for p in prompts]
        res = server.run(reqs)
        torch.cuda.synchronize()
        out.append({"wall_s": res["wall_s"], "tokens_per_s": res["tokens_per_s"],
                    "refresh_s": refresh,
                    "gc_collections": sum(s["collections"] for s in gc.get_stats()) - n0,
                    "gc_s": gc_s[0]})
    gc.callbacks.remove(on_gc)
    return {"root": str(root), "arch": arch, "layers": layers, "runs": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print("turn", json.dumps(turn(args.turn.resolve(), args.arch, args.layers,
                                      args.runs)), flush=True)
        return 0
    roots = dict(zip("AB", (r.resolve() for r in args.roots)))
    for label in args.order:
        cmd = [sys.executable, __file__, *map(str, args.roots), "--turn", str(roots[label]),
               "--arch", args.arch, "--layers", str(args.layers), "--runs", str(args.runs)]
        print(f"== {label}: {roots[label]}", flush=True)
        subprocess.run(cmd, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
