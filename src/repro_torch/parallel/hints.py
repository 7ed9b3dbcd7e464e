"""Sharding-hint seam between model code and the mesh — the port of
``repro.parallel.hints``.

JAX model code finds the mesh through ``jax.set_mesh``; here a caller
names the virtual mesh (:class:`~repro_torch.launch.mesh.VirtualMesh`)
with :func:`set_mesh`, and :func:`concrete_mesh` reads it back (the MoE
expert-parallel dispatch does). Logical axes resolve against the active
mesh as in JAX (:func:`resolve_spec`): every axis of a virtual mesh is
Auto, since one card runs every rank as a row of the stacked view in
one region and no axis is ever in JAX's Manual (``shard_map``) mode, so
:func:`manual_axis_names` is always empty. One card has no layout to
constrain, so :func:`maybe_shard` returns its input.

Logical axis vocabulary:
* ``BATCH``  -> ``("pod", "data")``  (data parallel, pods included)
* ``TP``     -> ``"model"``          (tensor / expert parallel)
* ``SEQ``    -> ``"data"``           (sequence parallelism for long ctx)
"""

from __future__ import annotations

import contextlib
import contextvars

from repro_torch.parallel.spec import P, keep_axes

# The data-parallel mesh axes, in canonical order.
BATCH: tuple[str, ...] = ("pod", "data")
TP = "model"
SEQ = "data"

AxisLike = str | tuple[str, ...] | None

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def dp_axes(axis_names) -> tuple[str, ...]:
    """The data-parallel subset of ``axis_names``, in canonical
    (:data:`BATCH`) order."""
    return tuple(a for a in BATCH if a in axis_names)


@contextlib.contextmanager
def set_mesh(mesh):
    """``jax.set_mesh``: ``mesh`` (a ``VirtualMesh``) is the active
    mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def concrete_mesh():
    """The mesh named by the innermost :func:`set_mesh`, or ``None``."""
    return _MESH.get()


def resolve_spec(*axes: AxisLike) -> P | None:
    """Resolve logical axes to a spec on the active mesh (axes it does
    not name dropped), or ``None`` when no mesh is active."""
    mesh = concrete_mesh()
    if mesh is None:
        return None
    return keep_axes(axes, mesh.axis_names)


def maybe_shard(x, *axes: AxisLike):
    """JAX's ``with_sharding_constraint`` hint: ``x`` itself (one card
    holds every row)."""
    return x


def manual_axis_names() -> tuple[str, ...]:
    """Axis names currently in Manual (``shard_map``) mode: none."""
    return ()
