"""Nested dict/list parameter trees (the port's stand-in for ``jax.tree``)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of matching dict/list trees; ``None`` is
    a leaf."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out
