#!/usr/bin/env python3
"""Flash-attention kernel times of two checkouts of the PyTorch port, in
turns, on one NVIDIA card.

    python3 scripts/flash_ab.py ROOT_A ROOT_B [--order ABBA] [--cases a,b,...]

Each turn is a fresh process that puts ``ROOT/src`` first on its path,
builds that tree's kernels (into ``ROOT/build``) and calls its public
``flash_attention`` on each case of ``CASES`` (inputs from a seeded
generator on the card): the route its ``_route`` names, the output
against its plain twin within ``chip_smoke.TOL`` (a case beyond it fails
the turn), the CUDA-event time (``chip_smoke.paired_ms`` against
PyTorch's ``scaled_dot_product_attention`` on the same inputs), the
profiler's device time of every kernel of one call (``device_ms`` with
no kernel name: a route's pre-pass counts), and SDPA's device time.
Each turn prints one ``case {...}`` line per case and ends with
``turn {...}``.

Times move between machines and calls, so compare only turns of one
call; ``--order ABBA`` interleaves them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (name, B, H, Hkv, S, D, dtype, causal, window)
CASES = [
    ("bf16_d40", 1, 4, 2, 160, 40, "bfloat16", True, None),
    ("bf16_d40_4k", 1, 32, 4, 4096, 40, "bfloat16", True, None),
    ("f32_d192_4k", 1, 16, 16, 4096, 192, "float32", True, None),
    ("f32_d256_4k", 1, 8, 2, 4096, 256, "float32", True, None),
    ("d80_gqa", 1, 8, 2, 256, 80, "bfloat16", True, None),
    ("f32_d192_path", 1, 16, 16, 256, 192, "float32", True, None),
    ("d256", 1, 2, 1, 128, 256, "float32", True, None),
    ("bf16_d8_window", 2, 4, 2, 333, 8, "bfloat16", True, 48),
    ("f16_d24_ragged", 1, 4, 1, 449, 24, "float16", True, None),
    ("bf16_d200_noncausal", 1, 4, 2, 300, 200, "bfloat16", False, None),
    ("f16_d248_window", 1, 4, 2, 333, 248, "float16", True, 48),
    ("f32_d136_window", 2, 4, 2, 333, 136, "float32", True, 48),
    ("f32_d200_ragged", 1, 8, 2, 449, 200, "float32", False, None),
]


def turn(root: Path, names: list[str]) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke  # timing helpers and tolerances; it imports nothing of the port

    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA

    if not Path(sys.modules["repro_torch"].__file__).is_relative_to(root):
        raise RuntimeError(f"imported {sys.modules['repro_torch'].__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(4)
    recs = {}
    for name, B, H, Hkv, S, D, dt, causal, window in CASES:
        if names and name not in names:
            continue
        dtype = getattr(torch, dt)
        q = torch.randn((B, H, S, D), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        v = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        kw = dict(causal=causal, window=window)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        atol, rtol = chip_smoke.TOL[dt]
        err = (got.float() - want.float()).abs()
        bad = int((err > atol + rtol * want.float().abs()).sum())
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"{root} {name}: {bad} elements beyond atol={atol} "
                                 f"rtol={rtol}; max abs err {float(err.max())}")
        rows = torch.arange(S, device="cuda")[:, None]
        cols = torch.arange(S, device="cuda")[None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window

        def library():
            if window is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        kernel = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
        ms, library_ms = chip_smoke.paired_ms(kernel, library)
        rec = {
            "name": name, "route": FA._route(dtype, D), "shape": [B, H, Hkv, S, D],
            "dtype": dt, "causal": causal, "window": window,
            "ms": ms, "device_ms": chip_smoke.device_ms(kernel, None),
            "library_ms": library_ms,
            "library_device_ms": chip_smoke.device_ms(library, None),
            "pairs": int(mask.sum()), "max_abs_err": float(err.max()),
        }
        print("case", json.dumps(rec), flush=True)
        recs[name] = rec
    return {"root": str(root), "cases": recs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--cases", default="", help="comma-separated names of CASES (default all)")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    names = [n for n in args.cases.split(",") if n]
    if args.turn is not None:
        print("turn", json.dumps(turn(args.turn.resolve(), names)), flush=True)
        return 0
    roots = dict(zip("AB", (r.resolve() for r in args.roots)))
    for label in args.order:
        cmd = [sys.executable, __file__, *map(str, args.roots), "--turn", str(roots[label]),
               "--cases", args.cases]
        print(f"== {label}: {roots[label]}", flush=True)
        subprocess.run(cmd, check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
