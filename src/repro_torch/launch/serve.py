"""Continuous-batching serving with Torrent P2MP weight AND KV multicast
— ``repro.launch.serve`` on PyTorch, on the card by default.

Two payloads ride the replica plan:

* **Weight refresh** — ``broadcast_weights`` streams the *entire*
  flattened parameter tree (chunked, byte-exact; the logged byte count
  is asserted against the params' true nbytes) down the persistent
  ``parallel.collectives.MultiChainPlan``'s sub-chains. The byte stream
  follows ``jax.tree_util.tree_flatten`` order, so it equals the JAX
  package's for the same weights.
* **KV-block multicast** — ``register_prefix`` prefills a shared prompt
  prefix ONCE, flattens its per-position KV rows to a dense bf16 matrix
  (:mod:`repro_torch.launch.paged_kv`), broadcasts the bytes to every
  replica as a ``core.program.plan_broadcast`` ChainProgram (priced by
  ``simulator.program_latency`` / ``program_wire_bytes``; delivered
  byte-exactly by ``MultiChainTask`` as device-to-device copies), and
  each receiving replica runs the relayout kernel to materialize its
  paged ``(page, F)`` block layout — pinned bit-exactly against the
  plain oracle. Requests whose prompt starts with a registered prefix
  are admitted by *seeding* the cached rows instead of re-prefilling.

The decode loop is slot-based continuous batching with per-slot
positions; admission prefills ONLY the admitted slot, and a slot
finishes only when *it* runs out of room. ``Server.scale_down`` re-forms
the live plan around lost replicas instead of rebuilding it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --requests 16 --max-new 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core.chaintask import MultiChainTask
from repro_torch.core.program import plan_broadcast, program_wire_bytes
from repro_torch.core.simulator import program_latency, unicast_latency
from repro_torch.core.topology import MeshTopology
from repro_torch.device import resolve_device
from repro_torch.launch.paged_kv import (
    PrefixCache,
    PrefixEntry,
    dense_from_bytes,
    extract_dense_kv,
    paged_ref,
    seed_cache_row,
    to_paged,
)
from repro_torch.launch.steps import (
    make_serve_step,
    make_slot_prefill_step,
    write_cache_slot,
)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.collectives import MultiChainPlan
from repro_torch.runtime.elastic import scale_down_plan
from repro_torch.tree import leaves, map_tree

log = logging.getLogger("repro_torch.serve")


def _assert_same_bytes(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if got.shape != want.shape or not torch.equal(
        got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    ):
        raise AssertionError(f"{what}: bytes differ")


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    arrival: int = 0  # decode tick the request becomes visible
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefix_hit: bool = False  # admitted by seeding a registered prefix
    t_admit: int | None = None  # decode tick admitted to a slot
    t_done: int | None = None  # decode tick the last token was emitted


@dataclasses.dataclass
class ServeConfig:
    arch: str = "yi-6b"
    smoke: bool = True
    batch: int = 4  # decode slots
    prompt_len: int = 16  # admission window: longest accepted prompt
    max_seq: int = 128
    eos: int = -1  # -1: run to max_new
    replicas: int = 4  # model replicas for weight/KV multicast
    page_size: int = 8  # KV page height (positions per paged block)
    prefix_cache_bytes: int | None = None  # None = unbounded, else LRU
    seed: int = 0


class Server:
    """Slot-based continuous batching with greedy decode, per-slot
    positions, and a multicast-fed prefix cache.

    ``device`` defaults to ``"cuda"`` (raises without a card unless
    ``"cpu"`` is asked for). ``model_cfg`` replaces the ``sc.arch`` /
    ``sc.smoke`` lookup (e.g. a depth-cut or ``attn_impl``-changed
    config); with the default the model is the JAX server's. A
    vision-language or encoder-decoder model raises
    ``NotImplementedError``: neither package's server can feed it."""

    def __init__(self, sc: ServeConfig, *, device="cuda",
                 model_cfg: ModelConfig | None = None):
        self.sc = sc
        self.device = resolve_device(device)
        if model_cfg is not None:
            self.cfg = model_cfg
        else:
            self.cfg = C.get_smoke_config(sc.arch) if sc.smoke else C.get_config(sc.arch)
        if self.cfg.family == "vlm" or self.cfg.is_encdec:
            # the slot prefill feeds tokens only: JAX's Server fails inside
            # its first prefill for these (M-RoPE positions, encoder
            # frames); their entry points are make_prefill_step and
            # make_serve_step
            raise NotImplementedError(
                f"Server cannot serve {self.cfg.name!r} ({self.cfg.family}): its prompts need "
                "embeds/positions or encoder frames, which the token-only slot prefill does "
                "not carry; the JAX Server cannot serve it either")
        gen = torch.Generator(device=self.device).manual_seed(sc.seed)
        self.params = T.model_init(gen, self.cfg, self.device)
        self.slot_prefill = make_slot_prefill_step(self.cfg, sc.max_seq)
        self.serve_step = make_serve_step(self.cfg)
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * sc.batch
        self.cache = T.init_cache(self.cfg, sc.batch, sc.max_seq, self.device)
        self.clock = 0  # decode ticks (the traffic harness's time base)
        self.steps = 0
        # P2MP bookkeeping (paper Fig. 4 host orchestration): ONE
        # persistent multi-chain plan for the replica set — elastic
        # scale-down re-forms it (endpoint-side) instead of rebuilding.
        self.replicas = sc.replicas
        self.topo = MeshTopology(max(2, sc.replicas), 1)
        self.plan = MultiChainPlan(
            self.topo, 0, list(range(1, sc.replicas)), scheduler="tsp"
        )
        self.multicast_log: list[dict] = []
        self.last_delivery: dict[int, torch.Tensor] = {}
        self.prefix_cache = PrefixCache(capacity_bytes=sc.prefix_cache_bytes)
        self.kv_multicast_log: list[dict] = []

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int32), device=self.device)

    # -- the paper's host-side P2MP: weight refresh to replicas ----------
    def broadcast_weights(self, chunk_bytes: int = 1 << 20,
                          new_params=None) -> dict:
        """Multicast the FULL parameter tree to every surviving replica
        down the persistent plan's sub-chains, ``chunk_bytes`` at a
        time. The logged ``bytes`` is asserted against the params' true
        nbytes. With no surviving destinations (``replicas=1``) nothing
        moves and the record says so (0 chunks / 0 delivered bytes).

        ``new_params`` replaces the served weights before streaming and
        version-invalidates the prefix cache; re-broadcasting unchanged
        weights keeps entries valid. ``last_delivery`` holds each
        replica's delivered byte stream (device memory)."""
        invalidated = 0
        if new_params is not None:
            self.params = new_params
            invalidated = self.prefix_cache.on_weights_update()
        dests = self.plan.survivors
        self.last_delivery = {}  # release the previous refresh first
        if not dests:
            rec = {
                "bytes": 0, "delivered_bytes": 0, "chunks": 0,
                "replicas": 1, "cycles": 0, "speedup_vs_unicast": 1.0,
                "noop": True, "prefix_invalidated": invalidated,
            }
            self.multicast_log.append(rec)
            return rec
        flat = leaves(self.params)
        true_nbytes = sum(x.nbytes for x in flat)
        # dtype-agnostic byte stream: the wire moves bytes, not floats
        payload = (
            torch.cat([x.contiguous().reshape(-1).view(torch.uint8) for x in flat])
            if flat
            else torch.zeros(0, dtype=torch.uint8, device=self.device)
        )
        delivery = {
            d: torch.empty_like(payload) for d in dests
        }  # each replica's stream, filled chunk by chunk
        cycles = unicast = chunks = delivered = 0
        step = max(1, int(chunk_bytes))
        for off in range(0, payload.numel(), step):
            chunk = payload[off : off + step]
            task = MultiChainTask(
                self.topo, 0, dests, chunk,
                chains=[list(c) for c in self.plan.chains],
            )
            bufs = task.run()
            for d, buf in bufs.items():
                delivery[d][off : off + buf.numel()] = buf
                delivered += buf.nbytes
            cycles += task.cycle_ledger["total"]
            unicast += task.unicast_cycles()
            chunks += 1
        self.last_delivery = delivery
        rec = {
            "bytes": payload.nbytes,
            "delivered_bytes": delivered,
            "chunks": chunks,
            "replicas": len(dests) + 1,
            "cycles": cycles,
            "speedup_vs_unicast": unicast / cycles if cycles else 1.0,
            "prefix_invalidated": invalidated,
        }
        if rec["bytes"] != true_nbytes:
            raise AssertionError(
                f"weight refresh logged {rec['bytes']} B but params hold "
                f"{true_nbytes} B"
            )
        self.multicast_log.append(rec)
        return rec

    # -- KV-block multicast: prefill a shared prefix once, chain it out --
    def register_prefix(self, tokens: np.ndarray) -> PrefixEntry:
        """Prefill a shared prompt prefix on the head replica, broadcast
        its KV rows to every survivor as a ``plan_broadcast``
        ChainProgram, and relayout them into paged blocks on receipt.

        Delivery is byte-exact and the modeled wire bytes
        (``program_wire_bytes``) are asserted against the bytes the
        chain task actually delivered; each replica's paged blocks are
        pinned bit-exactly against the plain oracle."""
        sc = self.sc
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        plen = int(tokens.size)
        if plen == 0 or plen % sc.page_size:
            raise ValueError(
                f"prefix length {plen} must be a positive multiple of "
                f"page_size={sc.page_size}"
            )
        if plen >= sc.max_seq:
            raise ValueError(f"prefix length {plen} >= max_seq {sc.max_seq}")
        # scratch B=1 prefill — the live slots are never touched
        _, one_cache = self.slot_prefill(self.params, self._tokens(tokens)[None])
        dense = extract_dense_kv(one_cache, 0, plen, sc.max_seq)
        paged = to_paged(dense, sc.page_size)
        # relayout kernel pinned against its plain oracle
        _assert_same_bytes(paged, paged_ref(dense, sc.page_size), "paged relayout")
        entry = PrefixEntry(
            tokens=tokens, page=sc.page_size, dense=dense, paged=paged
        )
        entry.broadcast = self._broadcast_kv(entry)
        self.prefix_cache.add(entry)
        self.kv_multicast_log.append(entry.broadcast)
        return entry

    def _broadcast_kv(self, entry: PrefixEntry) -> dict:
        """Chain the dense KV rows to the surviving replicas and paged-
        relayout them on each receiver."""
        dests = self.plan.survivors
        payload = entry.dense.contiguous().reshape(-1).view(torch.uint8)
        nbytes = payload.nbytes
        if not dests:
            entry.replica_paged = {0: entry.paged}
            return {
                "prefix_len": entry.plen, "bytes": nbytes,
                "delivered_bytes": 0, "wire_bytes": 0, "replicas": 1,
                "cycles": 0, "modeled_cycles": 0,
                "speedup_vs_unicast": 1.0, "noop": True,
            }
        chains = tuple(tuple(c) for c in self.plan.chains)
        program = plan_broadcast(self.topo.num_nodes, 0, chains)
        modeled_wire = program_wire_bytes(program, nbytes)
        modeled_cc = int(program_latency(self.topo, 0, program, nbytes))
        uni_cc = int(unicast_latency(self.topo, 0, dests, nbytes))
        task = MultiChainTask(
            self.topo, 0, dests, payload, chains=[list(c) for c in chains]
        )
        bufs = task.run()
        delivered = 0
        replica_paged = {0: entry.paged}
        F = entry.dense.shape[1]
        oracle = paged_ref(entry.dense, entry.page)
        for d, buf in bufs.items():
            rdense = dense_from_bytes(buf, entry.plen, F)
            # byte-exact delivery vs the prefilling replica
            _assert_same_bytes(rdense, entry.dense, f"KV delivery to replica {d}")
            rpaged = to_paged(rdense, entry.page)
            # receiver-side relayout pinned vs the plain oracle
            _assert_same_bytes(rpaged, oracle, f"paged relayout on replica {d}")
            replica_paged[d] = rpaged
            delivered += buf.nbytes
        # Two byte books, each checked against its own invariant: the
        # task must deliver the FULL payload to every destination, and
        # the planned program's wire bytes are (steps + K - 1) payloads,
        # which equals the delivered bytes exactly when the plan is a
        # single chain.
        if delivered != len(dests) * nbytes:
            raise AssertionError(
                f"KV broadcast delivered {delivered} B, expected "
                f"{len(dests)} x {nbytes} B"
            )
        if modeled_wire != (len(program.steps) + len(chains) - 1) * nbytes:
            raise AssertionError(
                f"planned program prices {modeled_wire} B, expected "
                f"{len(program.steps) + len(chains) - 1} x {nbytes} B"
            )
        entry.replica_paged = replica_paged
        return {
            "prefix_len": entry.plen,
            "bytes": nbytes,
            "delivered_bytes": delivered,
            "wire_bytes": modeled_wire,
            "replicas": len(dests) + 1,
            "cycles": int(task.cycle_ledger["total"]),
            "modeled_cycles": modeled_cc,
            "unicast_cycles": uni_cc,
            "speedup_vs_unicast": (
                uni_cc / modeled_cc if modeled_cc else 1.0
            ),
        }

    # -- elastic scale-down: re-form the live plan, never rebuild it -----
    def scale_down(self, replicas: int) -> tuple[int, ...]:
        """Shrink the replica set to ``replicas`` (keeping replica 0,
        the plan head). The lost members are spliced out of the live
        ``MultiChainPlan`` as a concurrent failure set. Returns the lost
        replica ids."""
        lost = scale_down_plan(self.plan, self.replicas, replicas)
        if lost:
            log.info("scale-down: lost replicas %s, plan re-formed", list(lost))
        self.replicas = int(replicas)
        return lost

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, arrival: int = 0) -> Request:
        """Queue a request. Prompts longer than the admission window are
        rejected HERE — never silently truncated — as are empty ones."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size > self.sc.prompt_len:
            raise ValueError(
                f"prompt length {prompt.size} exceeds the admission window "
                f"prompt_len={self.sc.prompt_len}; refusing to truncate"
            )
        req = Request(
            rid=len(self.queue), prompt=prompt, max_new=max_new,
            arrival=int(arrival),
        )
        self.queue.append(req)
        return req

    def _admit(self):
        """Fill free slots with arrived requests, prefilling ONLY the
        admitted slot — in-flight rows are never rebuilt."""
        waiting = [
            r for r in self.queue
            if not r.done and r.t_admit is None and r.arrival <= self.clock
        ]
        for i, slot in enumerate(self.slots):
            if (slot is None or slot.done) and waiting:
                r = waiting.pop(0)
                self.slots[i] = r
                r.t_admit = self.clock
                self._prefill_slot(i)

    def _prefill_slot(self, i: int):
        """Fill slot ``i``'s cache row and emit its first token.

        Prefix-cache hit: seed the registered prefix's multicast KV rows
        straight into the row and run only the prompt's suffix through
        single-row decode. Miss: exact-length full prefill of this row."""
        r = self.slots[i]
        prompt = r.prompt
        plen = int(prompt.size)
        entry = self.prefix_cache.lookup(prompt) if self.prefix_cache.entries else None
        if entry is not None:
            # keep at least one token to feed through decode so the
            # slot's first output falls out of the last suffix step
            seed = entry.plen if entry.plen < plen else plen - 1
            r.prefix_hit = True
            if seed:
                self.cache = seed_cache_row(self.cache, i, entry.dense, seed)
            one_cache = map_tree(lambda t: t[:, i : i + 1].clone(), self.cache)
            tok = None
            for p in range(seed, plen):
                tok, one_cache = self.serve_step(
                    self.params, self._tokens([int(prompt[p])]),
                    torch.tensor(p, dtype=torch.int32, device=self.device), one_cache,
                )
            self.cache = write_cache_slot(self.cache, one_cache, i)
            first = int(tok[0])
        else:
            first_tok, one_cache = self.slot_prefill(
                self.params, self._tokens(prompt)[None]
            )
            self.cache = write_cache_slot(self.cache, one_cache, i)
            first = int(first_tok[0])
        r.out.append(first)
        self._maybe_finish(r)

    def _maybe_finish(self, r: Request):
        t = r.out[-1]
        if (
            len(r.out) >= r.max_new
            or t == self.sc.eos
            or len(r.prompt) + len(r.out) >= self.sc.max_seq
        ):
            r.done = True
            r.t_done = self.clock

    def _active(self) -> list[int]:
        return [
            i for i, r in enumerate(self.slots)
            if r is not None and not r.done and r.out
        ]

    def step(self):
        """One decode step: every active slot advances at its OWN
        absolute position (inactive rows are parked at position 0 and
        their tokens discarded — their rows are rewritten on the next
        admission)."""
        active = self._active()
        if not active:
            return
        B = self.sc.batch
        cur = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)
        for i in active:
            r = self.slots[i]
            cur[i] = r.out[-1]
            pos[i] = len(r.prompt) + len(r.out) - 1
        toks, self.cache = self.serve_step(
            self.params, self._tokens(cur), self._tokens(pos), self.cache
        )
        self.clock += 1
        self.steps += 1
        nxt = toks.cpu().numpy()
        for i in active:
            r = self.slots[i]
            r.out.append(int(nxt[i]))
            self._maybe_finish(r)

    def run(self, requests: list[Request]) -> dict[str, Any]:
        t0 = time.time()
        self.broadcast_weights()  # weight multicast to the replica set
        while any(not r.done for r in requests):
            self._admit()
            if not self._active():
                future = [
                    r.arrival for r in self.queue
                    if not r.done and r.t_admit is None
                ]
                if not future:
                    break
                # idle until the next arrival
                self.clock = max(self.clock + 1, min(future))
                continue
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        served = [r for r in requests if r.done]
        lat = [r.t_done - r.arrival for r in served if r.t_done is not None]
        toks = sum(len(r.out) for r in requests)
        return {
            "requests": len(requests),
            "served": len(served),
            "generated_tokens": toks,
            "decode_steps": self.steps,
            "wall_s": wall,
            "tokens_per_s": toks / wall if wall else 0.0,
            "prefix_hit_rate": self.prefix_cache.hit_rate,
            "prefix_entries": len(self.prefix_cache.entries),
            "prefix_bytes": self.prefix_cache.total_bytes,
            "prefix_evictions": self.prefix_cache.evictions,
            "prefix_invalidations": self.prefix_cache.invalidations,
            "latency_ticks_p50": float(np.percentile(lat, 50)) if lat else 0.0,
            "latency_ticks_p99": float(np.percentile(lat, 99)) if lat else 0.0,
            "weight_multicast": self.multicast_log[-1] if self.multicast_log else None,
            "kv_multicast": self.kv_multicast_log[-1] if self.kv_multicast_log else None,
        }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="yi-6b", choices=C.ARCHS)
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sc = ServeConfig(
        arch=args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len,
        max_seq=args.prompt_len + args.max_new + 2,
    )
    server = Server(sc, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [
        server.submit(
            rng.integers(0, server.cfg.vocab_size, size=sc.prompt_len),
            args.max_new,
        )
        for _ in range(args.requests)
    ]
    out = server.run(reqs)
    log.info(
        "served %d requests, %d tokens in %.2fs (%.1f tok/s); "
        "weight multicast %.1fx vs unicast",
        out["requests"], out["generated_tokens"], out["wall_s"],
        out["tokens_per_s"],
        (out["weight_multicast"] or {}).get("speedup_vs_unicast", 0.0),
    )
    return out


if __name__ == "__main__":
    main()
