"""Elastic scaling — the port of ``repro.runtime.elastic``.

Serving side: replica loss re-forms the live multicast plan instead of
rebuilding it (:func:`scale_down_plan`). Training side: the mesh is
re-factorized (:func:`choose_mesh_shape`, :func:`make_elastic_mesh`: a
process mesh over the ``torch.distributed`` world, or the stacked virtual
mesh without one), and :func:`reshard_state` places a restored logical state
on a mesh: on a ``ProcessMesh`` this rank keeps its shards, as JAX's
``device_put`` onto a new layout leaves them on a device; in the stacked
view, which holds the whole state, it is a device move.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import ProcessMesh, VirtualMesh, make_host_mesh, make_process_mesh
from repro_torch.tree import map_tree


def scale_down_plan(plan, old_replicas: int, new_replicas: int) -> tuple[int, ...]:
    """Shrink a replica set [0, old) to [0, new) by re-forming the live
    multicast ``plan`` (any object with ``MultiChainPlan.reform``
    semantics) around the lost replica ids — never by rebuilding it.

    Returns the lost ids ``(new, ..., old-1)``. ``new_replicas`` must
    keep at least the plan head (replica 0). Raises ``RuntimeError``
    when the plan declines (a lost id was already spliced out — the
    caller's replica accounting is stale).
    """
    old, new = int(old_replicas), int(new_replicas)
    if not 0 < new <= old:
        raise ValueError(f"cannot scale {old} replicas down to {new}")
    lost = tuple(range(new, old))
    if not lost:
        return lost
    spec = lost[0] if len(lost) == 1 else lost
    if not plan.reform(spec):
        raise RuntimeError(
            f"plan declined to re-form around lost replicas {list(lost)}"
        )
    return lost


def choose_mesh_shape(num_devices: int, preferred_tp: int) -> tuple[int, int]:
    """(data, model) factorization for the available devices: keep the
    TP size when it divides, else the largest power-of-two TP that
    does."""
    tp = min(preferred_tp, num_devices)
    while num_devices % tp:
        tp //= 2
    tp = max(tp, 1)
    return num_devices // tp, tp


def make_elastic_mesh(num_devices: int, preferred_tp: int) -> VirtualMesh | ProcessMesh:
    """The ``(data, model)`` mesh :func:`choose_mesh_shape` factors
    ``num_devices`` into: a :class:`~repro_torch.launch.mesh.ProcessMesh`
    over the ``torch.distributed`` world when it is initialised (which
    must hold ``num_devices`` processes), else the stacked
    :class:`~repro_torch.launch.mesh.VirtualMesh` (which refuses a
    ``model`` axis > 1: TP runs in the process form only)."""
    data, model = choose_mesh_shape(num_devices, preferred_tp)
    if dist.is_available() and dist.is_initialized():
        return make_process_mesh(data=data, model=model)
    return make_host_mesh(data=data, model=model)


def reshard_state(state, mesh="cuda", specs=None, *, device=None):
    """Place a (restored) logical state tree. ``reshard_state(state,
    mesh, specs)`` is JAX's signature: on a ``ProcessMesh``, this rank's
    shards of each leaf (``parallel.sharding.shard_tree`` by ``specs``,
    a matching tree of ``PartitionSpec``s), on ``device`` (default: the
    current CUDA device); on a ``VirtualMesh``, the whole state on
    ``device``. The device-only form ``reshard_state(state, device)``
    (default ``"cuda"``) moves the whole state."""
    if isinstance(mesh, (str, torch.device)):
        dev = resolve_device(mesh)
    else:
        from repro_torch.parallel.sharding import shard_tree

        dev = resolve_device("cuda" if device is None else device)
        state = shard_tree(state, specs, mesh)
    return map_tree(lambda t: torch.as_tensor(t).to(dev), state)
