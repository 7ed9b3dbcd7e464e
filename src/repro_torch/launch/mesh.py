"""Meshes of the port — the port of ``repro.launch.mesh``.

Two forms, read alike (``mesh.axis_names`` and ``mesh.shape[axis]``, as
on a ``jax.sharding.Mesh``, and ``mesh.group(axes)``):

* :class:`VirtualMesh` only names axes and their sizes: one process runs
  every data-parallel rank as a row of the stacked view
  (``core.chainwrite``).
* :class:`ProcessMesh` is a mesh of ``torch.distributed`` processes, one
  rank each (``core.chainwrite_dist``): it also knows this rank's
  coordinates and holds one process group per data-parallel axis
  slice, so a collective over an axis runs on the group of the ranks
  that share this rank's other coordinates.

``mesh.group(axes)`` is where the two part: ``None`` on a
:class:`VirtualMesh` (the stacked view: every rank is a row here), the
process group on a :class:`ProcessMesh`. The layers below (collectives,
the MoE exchange, the tensor-parallel ops) branch on it and nothing
else.

:func:`make_production_mesh` is the JAX package's 16 × 16 (or
2 × 16 × 16) mesh in the process form.

A ``model`` (TP) axis larger than 1 exists only on a
:class:`ProcessMesh`, where each rank holds its shards of the state
(``parallel.sharding.shard_tree``) and the model code runs Megatron's
collectives over ``mesh.group("model")`` (``parallel.tp``). The stacked
:class:`VirtualMesh` refuses it: one process holding every TP shard as
a row would only simulate those collectives.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs sizes {self.axis_sizes}")
        if any(int(s) < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be positive, got {self.axis_sizes}")
        if dict(zip(self.axis_names, self.axis_sizes)).get("model", 1) != 1:
            raise NotImplementedError(
                "a model (TP) axis > 1 needs a ProcessMesh (make_process_mesh(model=...), "
                "one rank per process): the stacked view has no tensor-parallel form"
            )

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axes) -> None:
        """No process group: every rank of the mesh is a row of this
        process's stacked view."""
        return None


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> VirtualMesh:
    return VirtualMesh(tuple(axes), tuple(int(s) for s in shape))


def make_host_mesh(data: int | None = None, model: int = 1) -> VirtualMesh:
    """A ``("data", "model")`` mesh of ``data`` virtual DP ranks
    (default 1: the one card) and ``model`` = 1."""
    return make_mesh((1 if data is None else int(data), int(model)), ("data", "model"))


class ProcessMesh:
    """A mesh over the ``torch.distributed`` world, one rank per process,
    ranks laid out row-major over ``axis_names`` (``("pod", "data",
    "model")``: rank ``(pod·D + data)·M + model``, so the ranks of one
    TP group are consecutive: on one host, the NVLink neighbours).

    :meth:`group` returns the process group of the ranks that differ from
    this one only along the given axes (group rank = the linear index
    over those axes, as JAX's ``axis_index`` of an axis tuple). The
    groups are created once, in the same order on every rank
    (``dist.new_group`` must be called by the whole world alike): the
    whole world (unless one axis spans it), then one group per slice of
    each axis of size > 1, axis by axis. On NCCL each group this rank
    is in then runs one all-reduce, in that same order, so that no
    group's first operation is a point-to-point step that some of its
    ranks skip (an NCCL group's first ``batch_isend_irecv`` must be
    joined by every rank). Where every data-parallel axis has size 1 and
    the world does not (``(data=1, model=M)``), each rank also gets a
    group of its own: the DP axes' group, over which a reduction is the
    identity."""

    def __init__(self, axis_names: tuple[str, ...], axis_sizes: tuple[int, ...]) -> None:
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} vs sizes {self.axis_sizes}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"axis sizes must be positive, got {self.axis_sizes}")
        world = dist.get_world_size()
        if math.prod(self.axis_sizes) != world:
            raise ValueError(f"mesh {self.shape} has {math.prod(self.axis_sizes)} ranks, "
                             f"the world {world}")
        self.rank = dist.get_rank()
        coords, r = [], self.rank
        for size in reversed(self.axis_sizes):
            coords.append(r % size)
            r //= size
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        live = [a for a in self.axis_names if self.shape[a] > 1]
        self._groups = {}
        if len(live) != 1:
            self._groups[tuple(self.axis_names)] = dist.new_group(list(range(world)))
        for axis in live:
            mine = None
            for ranks in self._slices(axis):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._groups[(axis,)] = mine
        self._solo = None
        if world > 1 and math.prod(self.shape[a] for a in self.dp_axes) == 1:
            for r in range(world):
                g = dist.new_group([r])
                if r == self.rank:
                    self._solo = g
        for g in list(self._groups.values()) + [self._solo]:
            if g is None:
                continue
            if str(dist.get_backend(g)) == "nccl":
                dist.all_reduce(torch.zeros(1, device=torch.cuda.current_device()), group=g)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """The data-parallel axes, in canonical order (``pod``, ``data``)."""
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def dp_index(self) -> int:
        """This rank's linear index over the data-parallel axes: the
        block of a global batch it takes (its TP peers take the same)."""
        i = 0
        for a in self.dp_axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def _slices(self, axis: str) -> list[list[int]]:
        """Every slice along ``axis``: the ranks that share all other
        coordinates, in ``axis`` order."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.axis_sizes[i + 1:])
        size = self.axis_sizes[i]
        starts = [r for r in range(math.prod(self.axis_sizes)) if (r // stride) % size == 0]
        return [[s + k * stride for k in range(size)] for s in starts]

    def group(self, axes) -> object:
        """The process group over ``axes`` (one name or a tuple) that holds
        this rank. Axes of size 1 drop out; axes that all have size 1
        name this rank alone (a group of one, where the world has more);
        every live axis names the whole world."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = tuple(a for a in axes if self.shape[a] > 1)
        every = tuple(a for a in self.axis_names if self.shape[a] > 1)
        if not live and self._solo is not None:
            return self._solo
        if len(live) == 1:
            return self._groups[live]
        if set(live) == set(every):
            return self._groups[every if len(every) == 1 else tuple(self.axis_names)]
        raise ValueError(f"no process group over {axes} in mesh {self.shape}")

    def __repr__(self) -> str:
        return f"ProcessMesh({self.shape}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The production mesh over the initialised ``torch.distributed``
    world, one rank per process: ``("data", "model")`` = (16, 16) (256
    ranks), or ``("pod", "data", "model")`` = (2, 16, 16) with
    ``multi_pod`` (512 ranks), as ``repro.launch.mesh``'s. A world of
    any other size raises ``ValueError`` naming it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return ProcessMesh(axes, shape)


def make_process_mesh(data: int | None = None, model: int = 1,
                      pod: int | None = None) -> ProcessMesh:
    """A mesh over the initialised ``torch.distributed`` world:
    ``("data", "model")``, or ``("pod", "data", "model")`` with ``pod``;
    ``data`` defaults to what the world leaves for it; ``model`` is the
    TP size, whose groups are consecutive ranks."""
    world = dist.get_world_size()
    rest = world // (int(model) * (int(pod) if pod else 1))
    data = rest if data is None else int(data)
    if pod is None:
        return ProcessMesh(("data", "model"), (data, int(model)))
    return ProcessMesh(("pod", "data", "model"), (int(pod), data, int(model)))
