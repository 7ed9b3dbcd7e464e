"""Partition specs without JAX: the port's stand-in for
``jax.sharding.PartitionSpec``.

A spec names, per dim of an array, the mesh axis (or tuple of axes) it
is split over, or ``None`` for a replicated dim. The port's specs are
data: the sharding rules of ``parallel.sharding``, ``optim.adamw`` and
``launch.steps`` compute them, and nothing on one card applies them.
A spec is immutable, iterates over its entries and compares equal to
the tuple of them, so ``spec == tuple(jax_spec)`` holds entry by entry.
As on current JAX, a 1-tuple of axes is stored as its bare name
(``P(("data",)) == P("data")``) and an empty one as ``None``. A spec
is not a tuple, so the tree helpers (``repro_torch.tree``) treat it as
a leaf.
"""

from __future__ import annotations


def _entry(el):
    if el is None or isinstance(el, str):
        return el
    axes = tuple(el)
    if not all(isinstance(a, str) for a in axes):
        raise TypeError(f"a spec entry is None, an axis name or a tuple of them, got {el!r}")
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


class PartitionSpec:
    __slots__ = ("_parts",)

    def __init__(self, *parts) -> None:
        object.__setattr__(self, "_parts", tuple(_entry(p) for p in parts))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def keep_axes(parts, names) -> PartitionSpec:
    """A spec of ``parts`` (spec entries) with every axis not in
    ``names`` dropped: an entry left with no axis becomes ``None``, a
    tuple left with one becomes its name."""
    names = set(names)

    def keep(el):
        if isinstance(el, tuple):
            return tuple(a for a in el if a in names)
        return el if el in names else None

    return PartitionSpec(*(keep(el) for el in parts))


__all__ = ["P", "PartitionSpec", "keep_axes"]
