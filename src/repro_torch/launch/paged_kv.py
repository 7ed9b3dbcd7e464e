"""Paged KV blocks and the prefix cache behind KV-block multicast serving
— ``repro.launch.paged_kv`` on tensors.

A shared prompt prefix is prefilled ONCE on one replica, its
per-position KV rows are flattened into a dense ``(plen, F)`` bf16
matrix, the raw bytes are broadcast to the replica set down a
``core.program.plan_broadcast`` ChainProgram, and each receiving replica
runs the relayout kernel (``csrc/relayout.cu``) to convert the dense
rows into its paged ``(page, F)``-blocked layout. :func:`paged_ref` —
the plain reshape with ``relayout_ref``'s semantics for
``(1, F) -> (page, F)`` — pins the kernel output bit for bit.

Why this is exact: a position's KV row is that token's projection
(+RoPE at its absolute position) only, so a prefix's KV rows are
identical for any prompt sharing the prefix, and seeding them into a
fresh slot (:func:`seed_cache_row`) reproduces the full-prefill cache.

Wire layout: the cache leaves are walked in ``jax.tree.leaves`` order
(groups, pattern positions, then dict keys sorted: ``k`` before ``v``),
so ``F`` and every byte on the wire equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.relayout import relayout
from repro_torch.tree import leaves

__all__ = [
    "BF16",
    "kv_feature_width",
    "extract_dense_kv",
    "seed_cache_row",
    "to_paged",
    "paged_ref",
    "dense_from_bytes",
    "PrefixEntry",
    "PrefixCache",
]

BF16 = torch.bfloat16  # the wire dtype of KV caches


def _positional_leaves(cache: dict, max_seq: int) -> list:
    """The cache leaves carrying a per-position axis at dim 2:
    ``(reps, B, max_seq, *feat)``."""
    out = leaves(cache["layers"])
    for leaf in out:
        if leaf.dim() < 3 or leaf.shape[2] != max_seq:
            raise ValueError(
                "KV multicast needs per-position cache leaves "
                f"(reps, B, {max_seq}, ...); got {tuple(leaf.shape)} — "
                "non-attention mixers (mamba) are not supported"
            )
    return out


def kv_feature_width(cache: dict, max_seq: int) -> int:
    """F: bf16 values per cache position across all layers/leaves."""
    total = 0
    for leaf in _positional_leaves(cache, max_seq):
        total += leaf.shape[0] * math.prod(leaf.shape[3:])
    return total


def extract_dense_kv(cache: dict, row: int, plen: int, max_seq: int) -> torch.Tensor:
    """Flatten cache positions ``[0, plen)`` of slot ``row`` into a
    dense ``(plen, F)`` bf16 matrix on the cache's device
    (position-major, leaves concatenated along F in tree order)."""
    mats = []
    for leaf in _positional_leaves(cache, max_seq):
        a = leaf[:, row, :plen].to(BF16)  # (reps, plen, *feat)
        mats.append(a.movedim(0, 1).reshape(plen, -1))
    return torch.cat(mats, dim=1).contiguous()


def seed_cache_row(cache: dict, row: int, dense: torch.Tensor, seed_len: int) -> dict:
    """Inverse of :func:`extract_dense_kv`: write ``dense[:seed_len]``
    into positions ``[0, seed_len)`` of slot ``row``, in place; returns
    ``cache``. Exact — the seeded rows are bit-identical to a full
    prefill of the same tokens."""
    lv = leaves(cache["layers"])
    max_seq = lv[0].shape[2]
    _positional_leaves(cache, max_seq)  # validate
    off = 0
    for leaf in lv:
        reps, feat_shape = leaf.shape[0], tuple(leaf.shape[3:])
        width = reps * math.prod(feat_shape)
        if off + width > dense.shape[1]:
            raise ValueError(f"dense width {dense.shape[1]} < cache width {off + width}")
        seg = dense[:seed_len, off : off + width]
        off += width
        block = seg.reshape((seed_len, reps) + feat_shape).movedim(1, 0)
        leaf[:, row, :seed_len] = block.to(device=leaf.device, dtype=leaf.dtype)
    if off != dense.shape[1]:
        raise ValueError(f"dense width {dense.shape[1]} != cache width {off}")
    return cache


def to_paged(dense: torch.Tensor, page: int) -> torch.Tensor:
    """Dense ``(plen, F)`` rows -> paged ``(npages, page, F)`` blocks via
    the relayout kernel (``(1, F)``-blocked -> ``(page, F)``-blocked)."""
    plen, F = dense.shape
    if plen % page:
        raise ValueError(f"prefix length {plen} not a multiple of page {page}")
    src = dense.contiguous().reshape(plen, 1, 1, F)  # (1,F)-blocked
    return relayout(src, (plen, F), (1, F), (page, F))[:, 0]  # (npages, page, F)


def paged_ref(dense: torch.Tensor, page: int) -> torch.Tensor:
    """Plain oracle of :func:`to_paged`: a ``(page, F)`` block of a
    row-major ``(plen, F)`` matrix is ``page`` consecutive rows, so the
    paged layout is the reshape ``(plen // page, page, F)`` — the
    semantics of ``relayout_ref`` for ``(1, F) -> (page, F)``."""
    plen, F = dense.shape
    if plen % page:
        raise ValueError(f"prefix length {plen} not a multiple of page {page}")
    return dense.reshape(plen // page, page, F)


def dense_from_bytes(buf: torch.Tensor, plen: int, width: int) -> torch.Tensor:
    """Reinterpret a delivered uint8 wire buffer as the ``(plen, F)``
    bf16 dense KV matrix (zero-copy view)."""
    return buf.view(torch.uint8).view(BF16).reshape(plen, width)


@dataclasses.dataclass(eq=False)
class PrefixEntry:
    """One registered prefix: its tokens, the prefilling replica's dense
    KV rows, and the paged blocks each replica materialized on receipt."""

    tokens: np.ndarray  # (plen,) int32, host
    page: int
    dense: torch.Tensor  # (plen, F) bf16 — source-replica KV rows
    paged: torch.Tensor  # (npages, page, F) bf16 — source paged layout
    replica_paged: dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    broadcast: dict | None = None  # the plan_broadcast record (see serve)
    version: int = 0  # weights version the KV was prefilled under
    last_used: int = 0  # cache-recency tick (LRU bookkeeping)

    @property
    def plen(self) -> int:
        return int(self.tokens.size)

    @property
    def nbytes(self) -> int:
        """Device memory the cached prefix pins: source dense + paged
        layouts plus every replica's paged copy."""
        return (
            self.dense.nbytes
            + self.paged.nbytes
            + sum(p.nbytes for p in self.replica_paged.values())
        )


class PrefixCache:
    """Longest-prefix lookup over registered prompt prefixes, with a
    byte-capacity bound (LRU eviction) and version-tagged invalidation.

    * ``capacity_bytes=None`` (default) is unbounded. With a bound,
      :meth:`add` evicts least-recently-used entries (lookup hits
      refresh recency) until the cache fits; a single entry larger than
      the bound is itself rejected.
    * Entries are stamped with ``weights_version`` at :meth:`add`; a
      weight refresh calls :meth:`on_weights_update`, which bumps the
      version and drops every stale entry.
    """

    def __init__(self, capacity_bytes: int | None = None) -> None:
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self.entries: list[PrefixEntry] = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.weights_version = 0
        self._tick = 0

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    def _touch(self, entry: PrefixEntry) -> None:
        self._tick += 1
        entry.last_used = self._tick

    def add(self, entry: PrefixEntry) -> None:
        entry.version = self.weights_version
        self._touch(entry)
        self.entries.append(entry)
        if self.capacity_bytes is not None:
            while self.total_bytes > self.capacity_bytes and self.entries:
                lru = min(self.entries, key=lambda e: e.last_used)
                self.entries.remove(lru)
                self.evictions += 1

    def lookup(self, prompt: np.ndarray) -> PrefixEntry | None:
        """Longest registered prefix that ``prompt`` starts with (counted
        as a hit/miss for the serving stats). A hit refreshes the
        entry's LRU recency."""
        prompt = np.asarray(prompt)
        best = None
        for e in self.entries:
            if e.version != self.weights_version:
                continue  # stale KV: never serve across a weight refresh
            if e.plen <= prompt.size and np.array_equal(prompt[: e.plen], e.tokens):
                if best is None or e.plen > best.plen:
                    best = e
        if best is None:
            self.misses += 1
        else:
            self.hits += 1
            self._touch(best)
        return best

    def on_weights_update(self) -> int:
        """New weights arrived: bump the version and invalidate every
        entry prefilled under an older one. Returns the count dropped."""
        self.weights_version += 1
        stale = [e for e in self.entries if e.version != self.weights_version]
        if stale:
            self.entries = [
                e for e in self.entries if e.version == self.weights_version
            ]
            self.invalidations += len(stale)
        return len(stale)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
