"""Parameter trees (nested dicts, lists and tuples of tensors) in jax's
leaf order: dict keys sorted, sequences in order.  The DP round flattens
per-example gradients and splits noise keys in this order, so the port's
``(N, D)`` matrix and key assignment match the reference's."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in leaves(t)]
    return [tree]


def unflatten(tree, new_leaves):
    """A tree of ``tree``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and those of same-structured
    ``rest``), in a tree of the same structure."""
    return unflatten(tree, [fn(*ls) for ls in zip(leaves(tree),
                                                  *map(leaves, rest))])
