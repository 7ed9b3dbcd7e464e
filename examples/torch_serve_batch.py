"""End-to-end driver: serve a small LM with batched requests, on PyTorch.

The PyTorch twin of ``examples/serve_batch.py`` and the port's
end-to-end scenario (Torrent is an inference-SoC data-movement
architecture evaluated on DeepSeek-V3 attention): a slot-based
continuous-batching server whose weight distribution to the replica set
runs as a four-phase Torrent ChainTask (cfg → grant → data → finish),
with predicted-cycle accounting from the NoC model. A shared system
prompt is prefilled once; its KV rows are chained to every replica and
paged there by the relayout kernel.

The script runs on the card and raises without one unless
``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--requests 16]
      PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.launch.serve import ServeConfig, Server


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--arch", default="yi-6b")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def make_server(args: argparse.Namespace) -> Server:
    """The JAX example's ``Server``, on ``args.device`` (its weights are
    drawn from the seed; ``Server.broadcast_weights(new_params=...)``
    replaces them)."""
    sc = ServeConfig(
        arch=args.arch, smoke=True, batch=args.batch, prompt_len=16,
        max_seq=16 + args.max_new + 2, replicas=8,
    )
    return Server(sc, device=args.device)


def serve(server: Server, requests: int, max_new: int) -> dict:
    """Register an 8-token system prompt, then serve ``requests``
    requests of ``max_new`` tokens, every other one reusing the prompt.
    Returns the prefix's multicast record and pages, the requests and
    ``Server.run``'s record (the weight refresh included)."""
    rng = np.random.default_rng(0)

    # register a shared system prompt: prefilled once, its KV rows are
    # chained to every replica and paged via the relayout kernel
    system_prompt = rng.integers(0, server.cfg.vocab_size, size=8).astype(
        np.int32
    )
    entry = server.register_prefix(system_prompt)
    reqs = [
        server.submit(
            np.concatenate(
                [system_prompt,
                 rng.integers(0, server.cfg.vocab_size, size=8)]
            ).astype(np.int32)
            if i % 2 == 0
            else rng.integers(0, server.cfg.vocab_size, size=16),
            max_new,
        )
        for i in range(requests)
    ]
    return {"prefix_len": entry.plen, "kv": entry.broadcast,
            "pages": entry.paged.shape[0], "requests": reqs,
            "run": server.run(reqs)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    server = make_server(args)
    sc = server.sc
    where = (torch.cuda.get_device_name(server.device) if server.device.type == "cuda"
             else str(server.device))

    res = serve(server, args.requests, args.max_new)
    kv = res["kv"]
    print(f"KV multicast of a {res['prefix_len']}-token prefix to "
          f"{kv['replicas'] - 1} replicas: {kv['wire_bytes']} wire bytes "
          f"({kv['speedup_vs_unicast']:.2f}x vs unicast), "
          f"{res['pages']} pages/replica")
    print(f"submitting {args.requests} requests "
          f"({sc.batch} decode slots, greedy sampling, every other "
          f"request reusing the system prompt)...")
    out = res["run"]
    print(f"generated {out['generated_tokens']} tokens over "
          f"{out['decode_steps']} decode steps "
          f"({out['tokens_per_s']:.1f} tok/s on {where}); "
          f"prefix-cache hit rate {out['prefix_hit_rate']:.0%}, "
          f"p50/p99 latency {out['latency_ticks_p50']:.0f}/"
          f"{out['latency_ticks_p99']:.0f} ticks")
    wm = out["weight_multicast"]
    print(f"weight multicast to {sc.replicas - 1} replicas: "
          f"{wm['bytes']} bytes, {wm['cycles']} predicted cycles, "
          f"{wm['speedup_vs_unicast']:.2f}x vs unicast")
    for r in res["requests"][:3]:
        print(f"  request {r.rid}{' (hit)' if r.prefix_hit else ''}: {r.out}")
    return res


if __name__ == "__main__":
    main()
