"""Deterministic synthetic LM data pipeline with background prefetch —
the port of ``repro.data.pipeline``: the same numpy sources, so the same
seeds give the same batches in both packages.

Two sources:

* :class:`MarkovSource` — a fixed random k-ary Markov chain over the
  vocabulary. Entropy ≈ log(branch) nats/token, so a model that learns
  the chain drives CE from log(vocab) down toward log(branch) — this is
  what makes "train a ~100M model and watch the loss fall" meaningful
  with no external datasets.
* :class:`UniformSource` — i.i.d. uniform tokens (throughput testing).

Batches are generated per *step index* with a counter-based generator
(numpy Philox), so any host can regenerate any step independently —
restart/elastic-rescale replays the exact stream with zero coordination,
and each host can slice only its addressable rows (host-sharded
loading, ``batch(step, host_slice=rank_slice(...))``); the process
form's ``Trainer`` cuts each rank's rows in its placer
(``make_device_placer(mesh, spec)``).

:class:`Prefetcher` runs the source on a background thread with a
bounded queue and optionally places each batch on a device
(:func:`make_device_placer`, double-buffered H2D).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class MarkovSource:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 branch: int = 4, seed: int = 0):
        self.vocab, self.seq_len, self.global_batch = vocab, seq_len, global_batch
        self.branch = branch
        self.seed = seed
        rng = np.random.Generator(np.random.Philox(key=seed))
        # fixed transition table: token -> `branch` possible successors
        self.table = rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)

    def batch(self, step: int, *, host_slice: slice = slice(None)) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed + 1, counter=step))
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=B)
        choices = rng.integers(0, self.branch, size=(B, S))
        for t in range(S):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[host_slice, :-1],
            "labels": toks[host_slice, 1:],
        }


class UniformSource:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.global_batch = vocab, seq_len, global_batch
        self.seed = seed

    def batch(self, step: int, *, host_slice: slice = slice(None)) -> dict:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        toks = rng.integers(
            0, self.vocab, size=(self.global_batch, self.seq_len + 1), dtype=np.int32
        )
        return {"tokens": toks[host_slice, :-1], "labels": toks[host_slice, 1:]}


class Prefetcher:
    """Background-thread prefetch (+ optional device placement)."""

    def __init__(
        self,
        source,
        start_step: int = 0,
        depth: int = 2,
        place: Callable[[dict], dict] | None = None,
    ):
        self._source = source
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            if self._place is not None:
                batch = self._place(batch)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def rank_slice(global_batch: int, dp: int, rank: int) -> slice:
    """Rank ``rank``'s rows of a ``global_batch`` split over ``dp`` data
    ranks, for ``batch(step, host_slice=...)``: the rows that
    ``parallel.collectives.split_batch`` gives rank ``rank`` of the
    stacked form. ``rank`` is the DP coordinate (a ``ProcessMesh``'s
    ``dp_index``), which the ranks of one TP group share."""
    if global_batch % dp:
        raise ValueError(f"batch dim {global_batch} not divisible by {dp} DP ranks")
    n = global_batch // dp
    return slice(rank * n, (rank + 1) * n)


def make_device_placer(mesh="cuda", spec=None, *, device=None) -> Callable[[dict], dict]:
    """A placer that moves each numpy array of a batch onto a device as
    a tensor, without blocking the host.

    ``make_device_placer(mesh, spec)`` is JAX's signature: on a
    ``ProcessMesh`` each leaf of the global batch is cut to this rank's
    rows along the dim that ``spec`` (a ``PartitionSpec``) splits over
    the DP axes, by the rank's DP coordinate (``mesh.dp_index``), so the
    ranks of one TP group get the same rows; the device is ``device``
    (default: the current CUDA device). On a ``VirtualMesh`` every row
    stays (the stacked view holds them all). The device-only form,
    ``make_device_placer(device)`` (default ``"cuda"``), moves the
    whole batch."""
    if isinstance(mesh, (str, torch.device)):
        dev, rows = resolve_device(mesh), None
    else:
        dev = resolve_device("cuda" if device is None else device)
        rows = None
        if hasattr(mesh, "dp_index"):
            from repro_torch.parallel.collectives import dp_size_of
            from repro_torch.parallel.sharding import batch_axis

            axis = batch_axis(spec)
            rows = (axis, dp_size_of(mesh), mesh.dp_index)

    def place(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if rows is not None:
                axis, dp, r = rows
                idx = rank_slice(v.shape[axis], dp, r)
                v = v[(slice(None),) * axis + (idx,)]
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev, non_blocking=True)
        return out

    return place
