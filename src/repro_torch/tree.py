"""Nested dicts of tensors (the reference's pytrees of parameters and
optimizer state): leaves in JAX's flattening order, and maps over them."""

from __future__ import annotations

from typing import Any, List


def tree_leaves(tree) -> List[Any]:
    """Leaves in JAX's flattening order (dict keys sorted); anything that
    is not a dict is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``
    (which may hold subtrees there), visited in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)
