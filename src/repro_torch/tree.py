"""Nested dict/list containers of tensors ("trees"), walked in the same
leaf order as ``jax.tree_util``: dict keys sorted, lists and tuples in
order. Params and caches keep the JAX package's nesting, so this order
fixes the weight-multicast byte stream and the KV wire layout."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``jax.tree.map``: apply ``fn`` leaf-wise over trees of one shape."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_tree(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def unflatten(like: Any, flat: list) -> Any:
    """``jax.tree.unflatten``: ``flat`` (in :func:`leaves` order) put
    back into the nesting of ``like``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in :func:`leaves` order; a path holds the
    dict keys and list indices from the root (``jax.tree_util``'s
    ``tree_flatten_with_path``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in paths(t, prefix + (i,))]
    return [(prefix, tree)]


def map_with_path(fn: Callable, tree: Any, prefix: tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path``: ``fn(path, leaf)`` over
    ``tree``, with paths as :func:`paths` gives them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, t, prefix + (i,)) for i, t in enumerate(tree))
    return fn(prefix, tree)
