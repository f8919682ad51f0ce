"""Nested-dict parameter trees: the port's stand-in for `jax.tree`.

A tree is a leaf (a tensor, or anything `is_leaf` accepts) or a dict of
trees.  Every walk visits keys in sorted order, which is the order
`jax.tree.flatten` gives dicts, so leaf lists line up with the
reference's (`layer0/b`, `layer0/w`, `layer1/b`, ...).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

Tree = Any


def _is_node(tree, is_leaf) -> bool:
    return isinstance(tree, dict) and not (is_leaf is not None
                                           and is_leaf(tree))


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Tree:
    """Apply `fn` leafwise over trees of one structure."""
    if not _is_node(tree, is_leaf):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
            for k in sorted(tree)}


def tree_leaves(tree: Tree,
                is_leaf: Optional[Callable[[Any], bool]] = None) -> list:
    """Leaves in sorted-key order."""
    if not _is_node(tree, is_leaf):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k],
                                                               is_leaf)]


def tree_paths(tree: Tree, prefix: str = "") -> list[str]:
    """'/'-joined key paths of the leaves, in `tree_leaves` order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree)
            for p in tree_paths(tree[k], f"{prefix}/{k}" if prefix else k)]


def tree_unflatten(like: Tree, leaves: list) -> Tree:
    """Rebuild `like`'s structure from leaves in `tree_leaves` order."""
    it: Iterator = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
