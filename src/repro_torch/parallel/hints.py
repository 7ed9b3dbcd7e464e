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

JAX runs a function either over the global batch (GSPMD: the prefill
and serve cells, the ``collectives="xla"`` train step) or per device
inside a ``shard_map`` whose axes are Manual (the Torrent train step's
DP reduce). A process rank holds only its own rows either way; where a
function of the whole batch is needed (the flat MoE dispatch's capacity,
positions and aux statistics), :func:`global_dp_group` names the group
to reduce it over, and :func:`manual_axes` marks a block as a
``shard_map`` body, where each rank keeps its own.

A long-context decode cell (``long_500k``: global batch 1, its token
spec ``P()``) is the other case: every rank holds the whole, replicated
batch, and ``cache_pspecs`` splits the decode cache's slots over
``data`` instead (sequence parallelism). Inside :func:`replicated_batch`
no statistic of the global batch is reduced over the DP axes
(:func:`global_dp_group` is ``None``: a rank's batch is the global one),
and :func:`seq_group` names the group over which the cache's slots are
split, which the decode's softmax is combined over.

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
_MANUAL: contextvars.ContextVar = contextvars.ContextVar("repro_torch_manual", default=())
_REPLICATED: contextvars.ContextVar = contextvars.ContextVar("repro_torch_replicated",
                                                            default=False)


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


@contextlib.contextmanager
def manual_axes(axes: tuple[str, ...]):
    """JAX's ``shard_map`` over ``axes``: inside the block those mesh
    axes are Manual, so each rank computes on its own block as a
    ``shard_map`` device does, and :func:`global_dp_group` does not reach
    over them."""
    token = _MANUAL.set(tuple(_MANUAL.get()) + tuple(axes))
    try:
        yield
    finally:
        _MANUAL.reset(token)


def manual_axis_names() -> tuple[str, ...]:
    """Axis names currently in Manual (``shard_map``) mode
    (:func:`manual_axes`)."""
    return _MANUAL.get()


@contextlib.contextmanager
def replicated_batch():
    """Inside the block every rank holds the whole global batch,
    replicated over the DP axes (a decode cell whose token spec is
    ``P()``: ``long_500k``), so :func:`global_dp_group` reduces nothing
    over them, and a decode cache's slots are split over ``data``
    (:func:`seq_group`), as ``cache_pspecs`` splits them at global batch
    1."""
    token = _REPLICATED.set(True)
    try:
        yield
    finally:
        _REPLICATED.reset(token)


def batch_replicated() -> bool:
    """Whether the batch is replicated over the DP axes
    (:func:`replicated_batch`)."""
    return _REPLICATED.get()


def seq_group():
    """The process group over which a decode cache's slots are split on
    the active mesh (JAX's ``SEQ`` axis, ``data``): inside
    :func:`replicated_batch` on a mesh whose ``data`` axis is live and
    not Manual; else ``None`` (the rank holds every slot)."""
    mesh = concrete_mesh()
    if (mesh is None or not _REPLICATED.get() or mesh.shape.get(SEQ, 1) == 1
            or SEQ in _MANUAL.get()):
        return None
    return mesh.group(SEQ)


def global_dp_group():
    """The process group over the active mesh's live DP axes where none
    of them is Manual: the group over which a statistic of the global
    batch is reduced, since JAX's GSPMD function sees the whole batch
    where this rank holds its rows. ``None`` without a mesh, on the
    stacked view (which holds every row), with no live DP axis, inside
    :func:`manual_axes` of one, or inside :func:`replicated_batch`
    (the rank's batch is the global one)."""
    mesh = concrete_mesh()
    if mesh is None or _REPLICATED.get():
        return None
    live = tuple(a for a in dp_axes(mesh.axis_names) if mesh.shape.get(a, 1) > 1)
    if not live or set(live) & set(_MANUAL.get()):
        return None
    return mesh.group(live)


def snapshot():
    """A context-manager factory that re-enters the active mesh, the
    Manual axes and :func:`replicated_batch`: for a remat'd recompute,
    which runs on the autograd engine's thread for a CUDA device."""
    mesh, manual, replicated = _MESH.get(), _MANUAL.get(), _REPLICATED.get()

    @contextlib.contextmanager
    def enter():
        t1, t2, t3 = _MESH.set(mesh), _MANUAL.set(manual), _REPLICATED.set(replicated)
        try:
            yield
        finally:
            _REPLICATED.reset(t3)
            _MANUAL.reset(t2)
            _MESH.reset(t1)

    return enter
