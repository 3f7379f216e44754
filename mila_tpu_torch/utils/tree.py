"""Nested-dict parameter trees (the port's stand-in for JAX pytrees of
params): leaves are tensors, or any non-dict value, in insertion order."""

from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Any, prefix: tuple = ()) -> list:
    """The key path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [path for k, v in tree.items() for path in tree_paths(v, prefix + (k,))]
    return [prefix]


def sorted_leaf_index(tree: Any) -> list:
    """Each leaf's index (in leaf order) in JAX's ``tree_flatten`` order,
    which sorts every dict's keys: the order of the leaves' key paths."""
    paths = tree_paths(tree)
    out = [0] * len(paths)
    for rank, i in enumerate(sorted(range(len(paths)), key=paths.__getitem__)):
        out[i] = rank
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves_like(tree: Any, like: Any) -> list:
    """``tree``'s leaves in ``like``'s key order (dicts matched by key, as
    JAX pairs the leaves of two trees)."""
    if isinstance(like, dict):
        return [leaf for k, v in like.items() for leaf in tree_leaves_like(tree[k], v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` with ``leaves`` in its leaf order."""
    it = iter(leaves)

    def build(node):
        return {k: build(v) for k, v in node.items()} if isinstance(node, dict) else next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
