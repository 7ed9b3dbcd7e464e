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
