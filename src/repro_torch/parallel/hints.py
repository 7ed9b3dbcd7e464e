"""Sharding-hint seam between model code and the mesh — the port of
``repro.parallel.hints``.

JAX model code finds the mesh through ``jax.set_mesh``; here a caller
names the mesh (a :class:`~repro_torch.launch.mesh.VirtualMesh` or a
:class:`~repro_torch.launch.mesh.ProcessMesh`) with :func:`set_mesh`,
and :func:`concrete_mesh` reads it back (the MoE expert-parallel
dispatch does). Logical axes resolve against the active mesh as in JAX
(:func:`resolve_spec`): no axis is ever in JAX's Manual (``shard_map``)
mode, so :func:`manual_axis_names` is always empty, and a tensor has no
layout to constrain, so :func:`maybe_shard` returns its input.

Where JAX's ``maybe_shard`` lets GSPMD split a layer over the ``model``
axis, the port's model code asks :func:`tp_group` and :func:`tp_size`
for the active mesh's TP group and runs ``parallel.tp``'s collectives on
it (``None`` and 1 without a ``model`` axis > 1).

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
    """``jax.set_mesh``: ``mesh`` (a ``VirtualMesh`` or a
    ``ProcessMesh``) is the active mesh inside the block."""
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


def tp_group():
    """The process group of this rank's ``model`` (TP) axis on the active
    mesh, or ``None`` without a mesh or with a ``model`` axis of 1."""
    mesh = concrete_mesh()
    if mesh is None or mesh.shape.get(TP, 1) == 1:
        return None
    return mesh.group(TP)


def tp_size() -> int:
    """The size of the active mesh's ``model`` axis (1 without a mesh)."""
    mesh = concrete_mesh()
    return 1 if mesh is None else mesh.shape.get(TP, 1)


def tp_split_group(n: int):
    """The active TP group when it splits a dim of ``n`` (the TP size
    divides it, as ``param_pspecs`` decides), else ``None``: a dim the
    TP size does not divide stays whole, and its layer runs unsplit."""
    group = tp_group()
    return group if group is not None and n % tp_size() == 0 else None


def maybe_shard(x, *axes: AxisLike):
    """JAX's ``with_sharding_constraint`` hint: ``x`` itself (the port
    places state explicitly, by ``parallel.sharding.shard_tree``)."""
    return x


def manual_axis_names() -> tuple[str, ...]:
    """Axis names currently in Manual (``shard_map``) mode: none."""
    return ()
