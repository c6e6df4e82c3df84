"""The little of ``jax.tree`` the port's training code needs.

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or any
other objects) at the leaves — the port's param tree (``{"embed", ...,
"layers": [dict per layer]}``) and the optimizer state.  Dicts are walked
in sorted key order, as JAX walks them, so the leaf order does not depend
on insertion order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)], path the tuple of keys from the root."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out += flatten_with_paths(child, prefix + (k,))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten_like(tree, values) -> Any:
    """The structure of ``tree`` with its leaves replaced, in
    :func:`leaves` order, by ``values``."""
    it: Iterator = iter(values)

    def take(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        new = {k: take(child) for k, child in kids}
        if isinstance(node, dict):
            return {k: new[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(new[f] for f in node._fields))
        return type(node)(new[i] for i in range(len(node)))

    out = take(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten_like: more values than leaves")
    return out
