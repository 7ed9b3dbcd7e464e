"""Elastic scaling — the port of ``repro.runtime.elastic``.

Serving side: replica loss re-forms the live multicast plan instead of
rebuilding it (:func:`scale_down_plan`). Training side: the mesh is
re-factorized on the virtual mesh (:func:`choose_mesh_shape`,
:func:`make_elastic_mesh`), and :func:`reshard_state` is a device move,
because one card holds the whole state and has nothing to reshard.
"""

from __future__ import annotations

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import VirtualMesh, make_host_mesh
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


def make_elastic_mesh(num_devices: int, preferred_tp: int) -> VirtualMesh:
    data, model = choose_mesh_shape(num_devices, preferred_tp)
    return make_host_mesh(data=data, model=model)


def reshard_state(state, device="cuda"):
    """Move a (restored) state tree onto ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)
    return map_tree(lambda t: t.to(dev), state)
