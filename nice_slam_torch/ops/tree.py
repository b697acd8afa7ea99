"""Minimal pytree helpers over nested dicts / lists / tuples of tensors.

The port keeps the JAX package's parameter layout (nested dicts of
decoder weights, a dict of grids), so the optimizer and the converters
walk the same trees."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply fn leafwise over structurally identical trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
