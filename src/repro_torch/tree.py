"""Nested dict/list parameter trees (the port's stand-in for ``jax.tree``)."""
from __future__ import annotations


def tree_map(fn, *trees, is_leaf=None):
    """Map ``fn`` over the leaves of matching dict/list trees; ``None`` is
    a leaf, and so is any node of the first tree that ``is_leaf`` accepts
    (a ``dist/sharding.P`` is a tuple)."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), *trees,
                              is_leaf=is_leaf)


def tree_map_with_path(fn, *trees, is_leaf=None):
    """:func:`tree_map` with each leaf's path first: a tuple of ``str``
    keys, a dict's key as itself and a list position as ``str(i)``, which
    is what the reference's ``sharding._path_keys`` makes of a
    ``jax.tree_util`` path on the same tree."""
    return _walk(fn, is_leaf, (), *trees)


def _walk(fn, is_leaf, path, *nodes):
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``fn``'s closure (tensors of a
    # step) alive until the next full garbage collection
    n0 = nodes[0]
    if is_leaf is not None and is_leaf(n0):
        return fn(path, *nodes)
    if isinstance(n0, dict):
        return {k: _walk(fn, is_leaf, path + (str(k),), *(n[k] for n in nodes))
                for k in n0}
    if isinstance(n0, (list, tuple)):
        return [_walk(fn, is_leaf, path + (str(i),), *xs)
                for i, xs in enumerate(zip(*nodes))]
    return fn(path, *nodes)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out
