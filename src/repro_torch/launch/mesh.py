"""Virtual meshes: the axis sizes of a device mesh, with no devices —
the port of ``repro.launch.mesh``.

One card runs every data-parallel rank as a row of the stacked view
(``core.chainwrite``), so a mesh here only names axes and their sizes;
``mesh.axis_names`` and ``mesh.shape[axis]`` read as on a
``jax.sharding.Mesh``. A ``model`` (TP) axis larger than 1 raises
``NotImplementedError``: tensor-parallel sharding waits for the
multi-process backend.
"""

from __future__ import annotations

import dataclasses


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
                "a model (TP) axis > 1 waits for the multi-process backend"
            )

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> VirtualMesh:
    return VirtualMesh(tuple(axes), tuple(int(s) for s in shape))


def make_host_mesh(data: int | None = None, model: int = 1) -> VirtualMesh:
    """A ``("data", "model")`` mesh of ``data`` virtual DP ranks
    (default 1: the one card) and ``model`` = 1."""
    return make_mesh((1 if data is None else int(data), int(model)), ("data", "model"))
