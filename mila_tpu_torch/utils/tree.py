"""Nested-dict parameter trees (the port's stand-in for JAX pytrees of
params): leaves are tensors, or any non-dict value, in insertion order."""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in its leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
