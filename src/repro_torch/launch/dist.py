"""Starting the process form: one rank per process on
``torch.distributed``.

* :func:`init_from_env` joins the process group that ``torchrun`` set
  up (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and returns this rank's device:
  ``cuda:{LOCAL_RANK % device_count}``, or the CPU when the caller asks
  for it. The backend follows the device: NCCL on a card, gloo on the
  CPU.
* :func:`spawn` runs a function in ``world`` fresh processes joined by a
  ``file://`` rendezvous, and returns what each rank returned. The ranks
  have a hard timeout from the moment all of them have joined the
  process group: the children are killed when it expires, so a
  mismatched send and receive fails in seconds instead of hanging.
  Starting the ranks (each imports torch and the caller's module, which
  took up to 108 s for 8 ranks on a loaded 8-core host) has a limit of
  its own, ``STARTUP_TIMEOUT_S``.

Several ranks may share one card (``device="cuda"`` with fewer cards
than ranks): NCCL refuses two ranks on one device, so such a world
takes gloo, whose frames the executor stages through pinned host memory
(``core.chainwrite_dist.transport``).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

__all__ = ["init_from_env", "rank_device", "spawn"]


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or card ``local_rank % device_count``
    (raises without a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


# how long a collective or a receive of a ``torchrun`` rank may wait
# before it raises
INIT_TIMEOUT_S = 600.0


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_from_env(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes in the environment
    and return this rank's device (see the module docstring)."""
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev),
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return dev


# how long the ranks of a spawn may take to start and join their process
# group; the caller's timeout runs from there
STARTUP_TIMEOUT_S = 600.0


def _child(rank: int, fn, world: int, backend, device, timeout_s: float, tmp: str, args):
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the rendezvous waits for the slowest rank to start; the parent kills
    # the ranks timeout_s after they have all joined
    dist.init_process_group(backend or _backend(dev), init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=max(timeout_s,
                                                                   STARTUP_TIMEOUT_S)))
    open(os.path.join(tmp, f"joined{rank}"), "w").close()
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], world: int, *, backend: str | None = None, device="cuda",
          timeout_s: float = 120.0, args: tuple = ()) -> list[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh
    processes (``spawn`` start method, one CPU thread each) joined in one
    process group, and return each rank's return value in rank order.
    ``fn`` must be importable (a module-level function) and return
    something ``torch.save`` can write. ``device`` is the card unless the
    caller asks for the CPU; without a card it raises here, before any
    process starts. ``backend`` defaults to the device's (see
    :func:`init_from_env`). A rank that raises fails the call with its
    traceback; a world that has not finished ``timeout_s`` after all its
    ranks joined their process group (or has not joined within
    ``STARTUP_TIMEOUT_S``) is killed and raises :class:`TimeoutError`."""
    rank_device(device, 0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        ctx = mp.start_processes(_child, args=(fn, world, backend, device, timeout_s, tmp,
                                               tuple(args)),
                                 nprocs=world, join=False, start_method="spawn")
        deadline, joined = time.monotonic() + STARTUP_TIMEOUT_S, False
        try:
            while not ctx.join(timeout=max(0.05, min(1.0, deadline - time.monotonic()))):
                if not joined and all(os.path.exists(os.path.join(tmp, f"joined{r}"))
                                      for r in range(world)):
                    deadline, joined = time.monotonic() + timeout_s, True
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} spawned ranks did not finish in {timeout_s} s after joining"
                        if joined else f"{world} spawned ranks did not join their process "
                        f"group in {STARTUP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
