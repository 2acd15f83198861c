"""Trees of tensors: the parameter, optimizer-state and cache trees.

Dicts, lists and (Named)tuples are nodes; ``None`` is a node with no
children, as in ``jax.tree`` (a hybrid cache's absent tail); anything else
is a leaf, unless ``is_leaf`` says a node is one (the optimizer's int8
codec ``{"q", "scale"}``).  A ``PartitionSpec`` is a tuple but always a
leaf, so a tree of specs has the structure of the tree it describes.
The port's counterpart of ``jax.tree``'s flatten, unflatten, map and
``tree_map_with_path``, and of indexing and stacking the leading layer
axis of a stacked tree (``tree_index``, ``tree_unstack``,
``tree_stack``).
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch


class PartitionSpec(tuple):
    """The mesh axes each dimension of a leaf shards over, one entry a
    dimension: an axis name, a tuple of names (the first one major) or
    ``None`` (not split).  ``tuple(PartitionSpec(...))`` is
    ``tuple(jax.sharding.PartitionSpec(...))`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self) -> tuple:  # copy and pickle: the entries
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _node(x, is_leaf: Callable | None) -> bool:
    return isinstance(x, (dict, list, tuple)) and \
        not isinstance(x, PartitionSpec) and not (is_leaf and is_leaf(x))


def _rebuild(like: tuple, items):
    """A tuple of ``like``'s type (a NamedTuple takes its fields as
    arguments, a plain tuple one iterable)."""
    items = list(items)
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    """The leaves of ``tree`` in order (dicts in insertion order)."""
    if tree is None:
        return []
    if not _node(tree, is_leaf):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in tree_leaves(sub, is_leaf)]


def tree_unflatten(like, it: Iterator, is_leaf: Callable | None = None):
    """A tree of ``like``'s structure with leaves taken from ``it``."""
    if like is None:
        return None
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
    if isinstance(tree, tuple) and not isinstance(tree, PartitionSpec):
        keys = getattr(tree, "_fields", range(len(tree)))
        return _rebuild(tree, (tree_map_with_name(fn, v, str(k))
                               for k, v in zip(keys, tree)))
    return None if tree is None else fn(name, tree)


def tree_leaves_with_path(tree, path: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` for every leaf in ``tree_leaves`` order; ``path``
    is written as ``jax.tree_util.keystr`` writes it: ``['key']`` for a
    dict key, ``[i]`` for a list or tuple index, ``.field`` for a
    NamedTuple field."""
    if tree is None:
        return []
    if not _node(tree, None):
        return [(path, tree)]
    if isinstance(tree, dict):
        keys = [f"[{k!r}]" for k in tree]
    elif hasattr(tree, "_fields"):
        keys = [f".{f}" for f in tree._fields]
    else:
        keys = [f"[{i}]" for i in range(len(tree))]
    items = tree.values() if isinstance(tree, dict) else tree
    return [pair for key, sub in zip(keys, items)
            for pair in tree_leaves_with_path(sub, path + key)]


def tree_index(tree, i: int):
    """Layer ``i`` of a stacked tree: every leaf indexed on its axis 0."""
    return tree_map(lambda t: t[i], tree)


def tree_unstack(tree) -> list:
    """Every layer of a stacked tree at once: each leaf unbound on axis 0.
    In a backward pass one ``unbind`` a leaf stacks the layers'
    gradients into the stacked leaf's gradient, as ``jax.lax.scan``
    writes them; ``tree_index`` layer by layer would make each layer's
    gradient a zero-filled tensor of the whole stack and add them up."""
    cols = [torch.unbind(t) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, iter([c[i] for c in cols]))
            for i in range(len(cols[0]))]


def tree_stack(trees: list):
    """The inverse of ``tree_index``: the leaves of ``trees`` stacked on a
    new axis 0."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)
