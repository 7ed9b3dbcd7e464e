"""Serving-side elasticity: replica loss re-forms the live multicast
plan instead of rebuilding it (``repro.runtime.elastic.scale_down_plan``;
the mesh re-factorization half of that module is device-mesh code with
no counterpart here yet)."""

from __future__ import annotations


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
