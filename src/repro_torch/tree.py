"""Nested containers of tensors, walked as ``jax.tree_util`` walks a
pytree: dict keys in sorted order, ``NamedTuple`` fields and tuple / list
items in order, ``None`` an empty subtree; anything else is a leaf.

A leaf's path is named as the JAX package's checkpoints name it
(``repro.checkpoint.checkpoint._key_str``): a dict key as ``str(key)``, a
``NamedTuple`` field by its name, a tuple item as ``#i``. So a
``TrainState`` flattens to ``params/embed``, ``opt_state/m/embed``,
``opt_state/count``, ``step`` in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten_with_path", "leaves", "tree_map", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """((key name, child), ...) of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(f"#{i}", c) for i, c in enumerate(node)]
    return None


def flatten_with_path(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) for every leaf, in JAX's flattening order."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, c in kids:
            walk(c, path + (k,))
    walk(tree, ())
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in flattening
    order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}      # the caller's key order
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the parallel trees
    ``rest`` (matched by position in flattening order)."""
    others = [leaves(t) for t in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(mine, *others)])
