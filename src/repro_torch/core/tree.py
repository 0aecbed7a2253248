"""Pytree walking and the sequential scan: the port's counterparts of
``jax.tree.map`` / ``jax.tree.leaves`` and ``lax.scan``.

A tree is a dict (children in sorted key order), a list or tuple, ``None``
(no leaves) or a leaf — the rules of :mod:`repro_torch.checkpoint`'s
walker, so a state the patterns produce is one the checkpoint can write.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _is_node(tree) -> bool:
    if isinstance(tree, (list, tuple)) and hasattr(tree, "_fields"):
        raise TypeError("named tuples are not supported as pytree nodes")
    return isinstance(tree, (dict, list, tuple)) or tree is None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``,
    which have ``tree``'s structure; the result has it too."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return type(tree)(tree_map(fn, child, *(r[i] for r in rest))
                      for i, child in enumerate(tree))


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if not _is_node(tree):
        return [tree]
    if tree is None:
        return []
    children = (tree[k] for k in sorted(tree)) if isinstance(tree, dict) \
        else tree
    return [leaf for child in children for leaf in tree_leaves(child)]


def stack(trees):
    """The trees of a list stacked leaf by leaf along a new leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def scan(step: Callable, carry, xs) -> Tuple[Any, Any]:
    """``lax.scan`` as a host loop: ``step(carry, x) -> (carry, y)`` over the
    leading axis of ``xs``; returns the last carry and the ``y`` stacked.

    Each ``x`` is a view of ``xs`` (basic indexing with a Python int, so no
    value is read back from a device).  Unlike ``lax.scan`` an empty
    ``xs`` is refused: without a traced step there is no ``y`` structure.
    """
    m = len(tree_leaves(xs)[0])
    if m == 0:
        raise ValueError("scan over an empty stream prefix")
    ys = []
    for i in range(m):
        carry, y = step(carry, tree_map(lambda leaf: leaf[i], xs))
        ys.append(y)
    return carry, stack(ys)
