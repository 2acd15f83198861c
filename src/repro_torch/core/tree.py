"""Trees of tensors: the parameter, optimizer-state and cache trees.

Dicts, lists and (Named)tuples are nodes; anything else is a leaf, unless
``is_leaf`` says a node is one (the optimizer's int8 codec ``{"q",
"scale"}``).  The port's counterpart of ``jax.tree``'s flatten, unflatten,
map and ``tree_map_with_path``.
"""

from __future__ import annotations

from typing import Callable, Iterator


def _node(x, is_leaf: Callable | None) -> bool:
    return isinstance(x, (dict, list, tuple)) and not (is_leaf and is_leaf(x))


def _rebuild(like: tuple, items):
    """A tuple of ``like``'s type (a NamedTuple takes its fields as
    arguments, a plain tuple one iterable)."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    """The leaves of ``tree`` in order (dicts in insertion order)."""
    if not _node(tree, is_leaf):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in tree_leaves(sub, is_leaf)]


def tree_unflatten(like, it: Iterator, is_leaf: Callable | None = None):
    """A tree of ``like``'s structure with leaves taken from ``it``."""
    if not _node(like, is_leaf):
        return next(it)
    if isinstance(like, dict):
        return {k: tree_unflatten(v, it, is_leaf) for k, v in like.items()}
    if isinstance(like, list):
        return [tree_unflatten(v, it, is_leaf) for v in like]
    return _rebuild(like, (tree_unflatten(v, it, is_leaf) for v in like))


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree``'s structure."""
    cols = [tree_leaves(t, is_leaf) for t in (tree, *rest)]
    return tree_unflatten(tree, iter([fn(*xs) for xs in zip(*cols)]),
                          is_leaf)


def tree_map_with_name(fn: Callable, tree, name: str = ""):
    """``fn(name, leaf)`` over every leaf; ``name`` is the leaf's last path
    key (a NamedTuple field, a dict key or a list index)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_name(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_name(fn, v, str(i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        return _rebuild(tree, (tree_map_with_name(fn, v, str(k))
                               for k, v in zip(keys, tree)))
    return fn(name, tree)
