"""The mesh seam between model code and the virtual DP group — the part
of ``repro.parallel.hints`` that the MoE expert-parallel dispatch needs.

JAX model code finds the mesh through ``jax.set_mesh``; here a caller
names the virtual mesh (:class:`~repro_torch.launch.mesh.VirtualMesh`)
with :func:`set_mesh`, and :func:`concrete_mesh` reads it back. One
card runs every rank as a row of the stacked view, in one region: no
axis is ever in JAX's Manual (``shard_map``) mode, so
``manual_axis_names`` has no counterpart, and the sharding constraints
(``maybe_shard``/``resolve_spec``) would be no-ops that no ported
caller needs.
"""

from __future__ import annotations

import contextlib
import contextvars

# The data-parallel mesh axes, in canonical order.
BATCH: tuple[str, ...] = ("pod", "data")

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
