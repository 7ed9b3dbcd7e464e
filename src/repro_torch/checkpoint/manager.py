"""Async checkpointing with atomic publish — the port of
``repro.checkpoint.manager``, with the same on-disk layout, so a
checkpoint written by either package restores in the other.

Layout (one directory per step)::

    <root>/ckpt_000123/
        manifest.json   — treedef (path-keyed), shapes, dtypes
        <leaf-id>.npy   — one file per pytree leaf

Design points for the 1000+-node posture:

* **Atomic publish**: writes land in ``ckpt_N.tmp``; the directory is
  ``rename``d only after fsync of the manifest — a reader never sees a
  partial checkpoint, and a crash mid-save leaves only a ``.tmp`` that
  is garbage-collected on the next save.
* **Async**: ``save`` enqueues a host-copied snapshot and returns; a
  writer thread does the I/O. ``wait()`` drains (call before exit and
  before restore-after-failure in tests).
* **Device-agnostic restore**: leaves are stored as whole numpy arrays
  (the manifest's ``shard_grid`` field is where per-host shard files
  slot in on a cluster), keyed by their tree path: dict keys and list
  indices joined by ``/`` in sorted key order, as ``jax.tree_util``'s
  paths give them. ``restore`` returns a tree of tensors on ``device``.
* **keep_last_k** garbage collection.
* **One format for both forms.** With a ``group`` (the process form:
  one rank per process), rank 0 writes and every rank waits at a
  barrier in :meth:`wait`. The per-rank leaves (the ones under a key of
  :data:`PER_RANK`: the error-feedback residual, a rank's ``(1,
  *shape)`` row) are gathered to rank 0 on save as the ``(dp, *shape)``
  leaf the stacked form writes, and each rank restores its own row of
  it. A checkpoint written by either form restores in the other.
* **Placed state: tensor parallelism and ZeRO-1.** With a process
  ``mesh`` and the state's ``specs`` (``parallel.sharding.state_specs``),
  each leaf a rank holds is its block of the logical leaf: a TP shard
  of a param split over ``model``, a ZeRO-1 block of an AdamW moment
  split over ``data`` as well. Save gathers every leaf over every live
  axis its spec names (one leaf at a time, straight to the host) before
  rank 0 writes it; only the per-rank EF rows are gathered over
  ``model`` alone and then as rows. So the files are the logical leaves
  at any mesh; ``restore(..., specs=, mesh=)`` (JAX's ``shardings=``
  role) gives each rank its own blocks. A checkpoint written at TP = 2,
  or with ZeRO-1 on ``(data=2, model=2)``, restores on any other mesh
  (``(4, 1)``, ``(1, 1)``), in the stacked form and in the JAX package,
  and the reverse.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.chainwrite_dist import gather_rows
from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import gather_tree, shard_tree
from repro_torch.parallel.spec import keep_axes
from repro_torch.tree import leaves, paths, unflatten

PyTree = Any

_SEP = "/"

# top-level state keys whose leaves are per-rank rows in the process form
PER_RANK = ("ef",)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype to save")
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    """``{path key: host copy}`` — a snapshot, so the caller may change
    its tensors in place once this returns."""
    return {_key(path): _host(leaf) for path, leaf in paths(tree)}


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _per_rank(path: tuple) -> bool:
    return bool(path) and path[0] in PER_RANK


class CheckpointManager:
    """``group``: the ``torch.distributed`` group of the process form's
    data-parallel ranks (world rank 0 writes; see the module docstring),
    or None for one process. ``mesh`` and ``specs``: the process mesh
    and the specs of the state's leaves, which place each rank's block
    of them (tensor parallelism over ``model``, ZeRO-1 over ``data``)."""

    def __init__(self, root: str, keep_last_k: int = 3, *, group=None, mesh=None,
                 specs=None):
        self.root = root
        self.keep = keep_last_k
        self.group = group
        self.mesh, self.specs = mesh, specs
        self.row = 0 if group is None else dist.get_rank(group)
        self.rank = 0 if group is None else dist.get_rank()
        os.makedirs(root, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._errors: list[Exception] = []
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, blocking: bool = False) -> None:
        """Snapshot ``tree`` to the host now and write it in the
        background (``blocking``: before returning). In the process form
        every rank calls it: the per-rank leaves are gathered to rank 0,
        which writes."""
        if self.group is not None:
            specs = leaves(self.specs) if self.specs is not None else [None] * len(paths(tree))
            flat = {}
            for (path, leaf), spec in zip(paths(tree), specs):
                if spec is not None:  # the logical leaf, over every live axis of its spec
                    leaf = gather_tree(leaf, keep_axes(spec, ("model",)) if _per_rank(path)
                                       else spec, self.mesh)
                if _per_rank(path):  # the DP rows, point to point to rank 0
                    leaf = gather_rows(leaf[0], self.group)
                if self.rank == 0:
                    flat[_key(path)] = _host(leaf)  # host snapshot now
                del leaf
            if self.rank == 0:
                self._q.put((step, flat))
        else:
            self._q.put((step, _flatten(tree)))  # host snapshot now
        if blocking:
            self.wait()

    def _writer(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, flat = item
            try:
                self._write(step, flat)
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, flat: dict[str, np.ndarray]):
        name = f"ckpt_{step:09d}"
        tmp = os.path.join(self.root, name + ".tmp")
        final = os.path.join(self.root, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for i, (key, arr) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "shard_grid": None,  # per-host shard layout on a real cluster
            }
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"ckpt_{s:09d}"), ignore_errors=True)
        for d in os.listdir(self.root):  # orphaned tmp dirs
            if d.endswith(".tmp") and not self._q.unfinished_tasks > 1:
                full = os.path.join(self.root, d)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)

    def wait(self):
        """Drain the writes; in the process form every rank of the world
        returns once rank 0's have landed."""
        self._q.join()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors}")
        if self.group is not None:
            dist.barrier()

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=5)

    # -- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            m = re.fullmatch(r"ckpt_(\d+)", d)
            if m and os.path.exists(os.path.join(self.root, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: PyTree, *, specs=None, mesh=None,
                device=None) -> PyTree:
        """Restore into the structure of ``like`` (values ignored) as
        tensors on ``device`` (default: each leaf of ``like``'s device,
        or ``"cuda"`` when ``like`` holds no tensors). In the process
        form a per-rank leaf restores as this rank's ``(1, *shape)`` row
        of the saved ``(dp, *shape)`` leaf. ``specs`` and ``mesh`` (JAX's
        ``shardings=``; default: the manager's) restore each leaf as this
        rank's shard of it (``parallel.sharding.shard_tree``: the per-rank
        leaves' specs split dim 0 over the DP axes)."""
        specs = self.specs if specs is None else specs
        mesh = self.mesh if mesh is None else mesh
        spec_list = leaves(specs) if specs is not None else [None] * len(paths(like))
        cdir = os.path.join(self.root, f"ckpt_{step:09d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        dev = None if device is None else resolve_device(device)
        out = []
        for (path, leaf), spec in zip(paths(like), spec_list):
            key = _key(path)
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint {step} missing leaf {key}")
            rows = self.group is not None and _per_rank(path) and spec is None
            arr = np.load(os.path.join(cdir, meta["file"]),
                          mmap_mode="r" if rows or spec is not None else None)
            if spec is not None:
                arr = shard_tree(arr, spec, mesh)
            elif rows:
                if arr.shape[0] != dist.get_world_size(self.group):
                    raise ValueError(f"{key}: ckpt has {arr.shape[0]} rank rows for "
                                     f"{dist.get_world_size(self.group)} ranks")
                arr = arr[self.row:self.row + 1]
            expect = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != expect:
                raise ValueError(f"{key}: ckpt shape {arr.shape} != {expect}")
            target = dev or getattr(leaf, "device", None) or resolve_device("cuda")
            out.append(torch.from_numpy(np.array(arr, order="C")).to(target))
        return unflatten(like, out)
