#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. the card's name and power limit; build both CUDA kernels from
   ``src/repro_torch/csrc`` with ``nvcc`` (one process per source, all
   at once) and print the build seconds and ptxas reports;
2. relayout: the CUDA kernel against its plain twin, bit for bit, at the
   paged-KV shape of the serve phase and on the paper's layout pairs;
3. flash attention: the CUDA kernel against its plain twin at the serve
   phase's prefill shape, plus an f32 windowed case, a D=80 GQA case and
   a D=256 case, within the stated tolerances;
4. serve: a ``repro_torch.launch.serve.Server`` at yi-6b's full width
   (depth cut to 8 layers, ``attn_impl="flash"``, random weights from a
   seed): weight multicast, KV-prefix registration and multicast, then
   8 requests through ``run()``; both kernels' launch counters must move
   and the flash prefill logits must agree with the reference
   attention's.

Then one JSON line with every kernel's launches, times, bound and error,
and, as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}  # dense, SXM

# bf16 kernel vs its f32-accumulating plain twin: both round one f32
# result to bf16, so they differ by at most one bf16 ulp (2^-8 relative)
# plus f32 reordering; f32: reordering of f32 sums only.
TOL = {"bfloat16": (2e-2, 1e-2), "float16": (2e-3, 2e-3), "float32": (1e-4, 1e-4)}
# flash vs reference prefill logits through 8 bf16 layers: the two
# attention paths round differently in every layer; relative to the
# logit scale.
LOGIT_REL_TOL = 2e-2


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float | None:
    """Device time of ``kernel`` per call of ``fn``, from the profiler's
    CUDA trace (None when the trace holds no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        for e in prof.key_averages() if kernel in e.key
    )
    return total_us / iters / 1e3 if total_us else None


def relayout_phase() -> dict:
    import torch
    from repro_torch.kernels.relayout import ops as R
    from repro_torch.launch.paged_kv import paged_ref

    def nbytes(t):
        return t.numel() * t.element_size()

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        # (name, shape, src, dst, dtype): the serve phase's paged-KV
        # relayout first (plen 384, F = 8 layers * 2 * 4 kv heads * 128)
        ("paged_kv", (384, 8192), (1, 8192), (8, 8192), torch.bfloat16),
        ("MNM16N8->MNM8N8", (2048, 192), (16, 8), (8, 8), torch.float32),
        ("MNM16N8->MNM64N16", (2048, 192), (16, 8), (64, 16), torch.float32),
        ("MNM8N8->MNM16N16", (2048, 192), (8, 8), (16, 16), torch.float32),
        ("MNM16N8->MNM8N8 int8", (2048, 192), (16, 8), (8, 8), torch.int8),
    ]
    main = None
    for name, shape, src, dst, dtype in cases:
        M, N = shape
        dense = (torch.randn(shape, device="cuda", generator=gen) * 8).to(dtype)
        x = R.dense_to_blocked(dense, src)
        got = R.relayout(x, shape, src, dst)
        want = R.relayout_ref(x, shape, src, dst)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"relayout {name}: kernel differs from relayout_ref")
        if name == "paged_kv":
            paged = got[:, 0]
            if not torch.equal(paged.view(torch.uint8), paged_ref(dense, dst[0]).view(torch.uint8)):
                raise AssertionError("relayout paged_kv: kernel differs from paged_ref")

        def library(x=x, shape=shape, dst=dst):
            dm = x.permute(0, 2, 1, 3).reshape(shape)
            return dm.reshape(M // dst[0], dst[0], N // dst[1], dst[1]).permute(
                0, 2, 1, 3).clone(memory_format=torch.contiguous_format)

        if not torch.equal(library().view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"relayout {name}: library expression differs")
        rec = {
            "name": name, "shape": list(shape), "dtype": str(dtype).split(".")[-1],
            "ms": time_ms(lambda: R.relayout(x, shape, src, dst)),
            "device_ms": device_ms(lambda: R.relayout(x, shape, src, dst), "relayout_kernel"),
            "plain_ms": time_ms(lambda: R.relayout_ref(x, shape, src, dst)),
            "library_ms": time_ms(library),
            "bound_ms": 2 * nbytes(x) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": float((got.double() - want.double()).abs().max()),
        }
        print("relayout", json.dumps(rec), flush=True)
        main = main or rec
    return main


def flash_phase() -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [
        # (name, B, H, Hkv, S, D, dtype, causal, window): the serve
        # phase's prefill shape (yi-6b heads, S=512) first
        ("yi6b_prefill", 1, 32, 4, 512, 128, torch.bfloat16, True, None),
        ("f32_window", 2, 4, 2, 384, 64, torch.float32, True, 48),
        ("f32_window_noncausal", 1, 4, 4, 200, 64, torch.float32, False, 100),
        ("d80_gqa", 1, 8, 2, 256, 80, torch.bfloat16, True, None),
        ("d256", 1, 2, 1, 128, 256, torch.float32, True, None),
    ]
    main = None
    for name, B, H, Hkv, S, D, dtype, causal, window in cases:
        q = torch.randn((B, H, S, D), device="cuda", generator=gen).to(dtype)
        k = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        v = torch.randn((B, Hkv, S, D), device="cuda", generator=gen).to(dtype)
        kw = dict(causal=causal, window=window)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        if got.dtype != q.dtype or got.shape != q.shape:
            raise AssertionError(f"flash {name}: output {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash {name}: non-finite output")
        dt = str(dtype).split(".")[-1]
        atol, rtol = TOL[dt]
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bad.any():
            raise AssertionError(
                f"flash {name}: {int(bad.sum())} elements beyond atol={atol} "
                f"rtol={rtol}; max abs err {float(err.max())}"
            )
        rows = torch.arange(S, device="cuda")[:, None]
        cols = torch.arange(S, device="cuda")[None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device="cuda")
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window

        def library():
            if window is None:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        pairs = int(mask.sum())  # (row, col) pairs this input needs
        flops = 4 * D * B * H * pairs  # QK^T and PV, 2 flops per MAC
        io_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops = flops / PEAK_OPS_PER_S[dt]
        t_bytes = io_bytes / HBM_BYTES_PER_S
        rec = {
            "name": name, "shape": [B, H, Hkv, S, D], "dtype": dt,
            "causal": causal, "window": window, "atol": atol, "rtol": rtol,
            "ms": time_ms(lambda: FA.flash_attention(q, k, v, **kw)),
            "device_ms": device_ms(lambda: FA.flash_attention(q, k, v, **kw), "flash_fwd_kernel"),
            "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v, **kw)),
            "library_ms": time_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": float(err.max()),
        }
        print("flash", json.dumps(rec), flush=True)
        main = main or rec
    return main


def serve_phase() -> dict:
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relayout import ops as R
    from repro_torch.launch.serve import ServeConfig, Server
    from repro_torch.models import transformer as T

    # yi-6b at full width (d_model 4096, 32 heads, 4 kv heads, head_dim
    # 128, d_ff 11008, vocab 64000); depth cut 32 -> 8 so params, the
    # weight payload and 3 delivered copies fit one 80 GB card.
    cfg = dataclasses.replace(C.get_config("yi-6b"), num_layers=8, attn_impl="flash")
    sc = ServeConfig(arch="yi-6b", smoke=False, batch=4, replicas=4, page_size=8,
                     prompt_len=512, max_seq=546, seed=0)
    t0 = time.perf_counter()
    server = Server(sc, device="cuda", model_cfg=cfg)
    torch.cuda.synchronize()
    print(f"serve: model init {time.perf_counter() - t0:.2f}s", flush=True)

    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    prefix = rng.integers(0, V, size=384).astype(np.int32)
    prompts = []
    for _ in range(6):  # prefix hits: prefix + 16..128 suffix tokens
        suffix = rng.integers(0, V, size=int(rng.integers(16, 129))).astype(np.int32)
        prompts.append(np.concatenate([prefix, suffix]))
    for _ in range(2):  # misses: 256..512 fresh tokens
        p = rng.integers(0, V, size=int(rng.integers(256, 513))).astype(np.int32)
        p[0] = (prefix[0] + 1) % V
        prompts.append(p)

    R.relayout.launches = 0
    FA.flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    spans = {}
    t0 = time.perf_counter()
    wrec = server.broadcast_weights(chunk_bytes=64 << 20)
    torch.cuda.synchronize()
    spans["broadcast_weights_64MiB_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry = server.register_prefix(prefix)
    torch.cuda.synchronize()
    spans["register_prefix_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server.broadcast_weights()  # the refresh run() starts with: 1 MiB chunks
    torch.cuda.synchronize()
    spans["broadcast_weights_1MiB_s"] = time.perf_counter() - t0
    reqs = [server.submit(p, 32) for p in prompts]
    out = server.run(reqs)
    torch.cuda.synchronize()
    spans["run_s"] = out["wall_s"]
    launches = {"relayout": R.relayout.launches, "flash_attention": FA.flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print("serve: weight multicast", json.dumps(wrec), flush=True)
    print("serve: kv multicast", json.dumps(entry.broadcast), flush=True)
    print("serve: run", json.dumps(out), flush=True)
    print(f"serve: wall_s {out['wall_s']:.3f} tokens/s {out['tokens_per_s']:.2f} "
          f"peak memory {peak_gb:.1f} GB launches {launches}", flush=True)
    print("serve: spans", json.dumps(spans), flush=True)

    if out["served"] != len(reqs) or not all(len(r.out) == 32 for r in reqs):
        raise AssertionError(f"served {out['served']} of {len(reqs)} requests")
    if [r.prefix_hit for r in reqs] != [True] * 6 + [False] * 2:
        raise AssertionError(f"prefix hits {[r.prefix_hit for r in reqs]}")
    if any(not 0 <= t < V for r in reqs for t in r.out):
        raise AssertionError("a generated token is outside the vocabulary")
    n_params = sum(x.numel() * x.element_size() for x in server.last_delivery.values())
    if wrec["delivered_bytes"] != 3 * wrec["bytes"] or n_params != wrec["delivered_bytes"]:
        raise AssertionError(f"weight multicast delivered {wrec['delivered_bytes']} B")
    if entry.broadcast["delivered_bytes"] != 3 * entry.broadcast["bytes"]:
        raise AssertionError("KV multicast did not reach every replica")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # flash vs reference attention on one prompt, same weights
    toks = torch.as_tensor(prompts[-1], device="cuda")[None]
    with torch.no_grad():
        lf, _ = T.prefill(server.params, cfg, {"tokens": toks}, sc.max_seq)
        lr, _ = T.prefill(server.params, dataclasses.replace(cfg, attn_impl="reference"),
                          {"tokens": toks}, sc.max_seq)
    torch.cuda.synchronize()
    if lf.shape != (1, V) or not torch.isfinite(lf).all():
        raise AssertionError(f"flash prefill logits {tuple(lf.shape)} not finite")
    d = float((lf - lr).abs().max())
    scale = float(lr.abs().max())
    print(f"serve: prefill logits flash vs reference: max |d| {d:.5f}, "
          f"max |ref| {scale:.3f}, argmax {int(lf.argmax())} vs {int(lr.argmax())}",
          flush=True)
    if d > LOGIT_REL_TOL * scale:
        raise AssertionError(f"flash prefill logits differ by {d} (> {LOGIT_REL_TOL} x {scale})")
    profile_run(server, [prompts[0], prompts[-1]])
    return launches


def profile_run(server, prompts) -> None:
    """Where the time goes: one more ``run()`` (weight refresh included)
    with two requests, a prefix hit and a miss, under the profiler's CUDA
    trace. Prints the device's busy share of the wall time and the
    kernels that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = [server.submit(p, 8) for p in prompts]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile: run() wall {wall_us / 1e6:.3f}s, device busy {busy_us / 1e6:.3f}s "
          f"({busy_us / wall_us:.1%}), idle share {1 - busy_us / wall_us:.1%}", flush=True)
    for name, us in top:
        print(f"profile:   {us / 1e3:10.3f} ms  {us / busy_us:6.1%}  {name[:100]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    smi = smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f}s wall, per source "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})}", flush=True)
    for name, logtext in _build.BUILD_LOG.items():
        used = sorted({line.split(":", 1)[-1].strip() for line in logtext.splitlines()
                       if "Used" in line or "spill stores" in line})
        print(f"ptxas {name}: {'; '.join(used)}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    relayout_rec = relayout_phase()
    flash_rec = flash_phase()
    launches = serve_phase()

    def row(name, source, replaces, rec, bound_by):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": bound_by, "library_ms": rec["library_ms"],
            "device_ms": rec["device_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
        }

    kernels = [
        row("relayout", "src/repro_torch/csrc/relayout.cu",
            "src/repro/kernels/relayout/kernel.py:55", relayout_rec, "bytes"),
        row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:100", flash_rec,
            flash_rec["bound_by"]),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
