"""Nested containers of tensors (the port's pytrees): flatten, map, rebuild.

Containers are dicts (keys in sorted order, as ``jax.tree`` flattens
them), lists, tuples, named tuples and dataclasses; ``None`` holds no
leaf; anything else is a leaf.  Each leaf has a path, the keys, indices
or field names from the root joined by "/", which the checkpoint
manifest records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["tree_flatten", "tree_leaves", "tree_map"]


def _children(node):
    """(names, children, rebuild) of a container node, or None for a
    leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return ([str(k) for k in keys], [node[k] for k in keys],
                lambda vals: type(node)(zip(keys, vals)))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (list(node._fields), list(node),
                lambda vals: type(node)(*vals))
    if isinstance(node, (list, tuple)):
        return ([str(i) for i in range(len(node))], list(node),
                lambda vals: type(node)(vals))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        fields = [f.name for f in dataclasses.fields(node)]
        return (fields, [getattr(node, f) for f in fields],
                lambda vals: dataclasses.replace(node, **dict(zip(fields,
                                                                  vals))))
    return None


def tree_flatten(tree) -> tuple[list[str], list, Callable[[list], Any]]:
    """(paths, leaves, unflatten): ``unflatten(new_leaves)`` rebuilds the
    tree's structure around new leaves in the same order."""
    paths, leaves = [], []

    def walk(node, prefix):
        if node is None:
            return lambda it: None
        kids = _children(node)
        if kids is None:
            paths.append(prefix)
            leaves.append(node)
            return lambda it: next(it)
        names, children, rebuild = kids
        builders = [walk(c, f"{prefix}/{n}" if prefix else n)
                    for n, c in zip(names, children)]
        return lambda it: rebuild([b(it) for b in builders])

    build = walk(tree, "")
    return paths, leaves, lambda new: build(iter(new))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[1]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    _, leaves, unflatten = tree_flatten(tree)
    others = [tree_flatten(t)[1] for t in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: {len(o)} leaves against "
                             f"{len(leaves)}")
    return unflatten([fn(*xs) for xs in zip(leaves, *others)])
