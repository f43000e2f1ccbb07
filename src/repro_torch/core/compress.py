"""Gradient-compression baselines the paper contrasts SPB against (§1, §5)
(the counterpart of ``repro/core/compress.py``).

Dense round-trip semantics: each compressor returns what the receiving end
reconstructs, in the gradient's shape and dtype.  The gradients are still
fully computed; only the bytes a data-parallel reduce would move shrink.

The random compressors draw from an explicit ``torch.Generator``: ``randk``
its indices, ``lowrank`` its projection ``q``.  They cannot reproduce
``jax.random``'s streams, so :func:`lowrank_apply` is a draw followed by
:func:`_lowrank_project`, which a test feeds the reference's own ``q``.
The draws are made on the generator's device and then moved to the
gradient's, so a CPU generator gives the card and the CPU the same draws.
"""
from __future__ import annotations

from typing import Any, List

import torch


def _keep(g: torch.Tensor, ratio: float) -> int:
    return max(1, int(g.numel() * ratio))


def topk_apply(g: torch.Tensor, ratio: float) -> torch.Tensor:
    """Keep the ``max(1, int(size * ratio))`` entries largest in magnitude,
    zeros elsewhere."""
    flat = g.reshape(-1)
    idx = torch.topk(flat.abs(), _keep(g, ratio), sorted=False).indices
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(g.shape)


def randk_apply(g: torch.Tensor, ratio: float,
                gen: torch.Generator) -> torch.Tensor:
    """Keep ``max(1, int(size * ratio))`` entries drawn without replacement,
    each scaled by ``1 / ratio`` (unbiased), zeros elsewhere."""
    flat = g.reshape(-1)
    idx = torch.randperm(flat.numel(), generator=gen,
                         device=gen.device)[:_keep(g, ratio)].to(g.device)
    out = torch.zeros_like(flat)
    out[idx] = flat[idx] * (1.0 / ratio)
    return out.reshape(g.shape)


def _lowrank_project(g: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """One PowerSGD power iteration from the (cols, rank) draw ``q``:
    ``P Pᵀ M`` with ``P`` the orthonormal basis of ``M q`` and ``M`` the
    gradient as (rows, cols) in f32.  The product does not depend on the
    signs QR gives P's columns."""
    m = g.reshape(g.shape[0], -1).float()
    p, _ = torch.linalg.qr(m @ q.to(m.device, torch.float32))
    approx = p @ (m.T @ p).T
    return approx.reshape(g.shape).to(g.dtype)


def lowrank_apply(g: torch.Tensor, rank: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Rank-``rank`` approximation of ``g`` (a leaf of fewer than two dims
    passes unchanged)."""
    if g.dim() < 2:
        return g
    cols = g[0].numel()
    q = torch.randn((cols, rank), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return _lowrank_project(g, q)


def _sorted_paths(tree, prefix=()) -> List[tuple]:
    """Leaf paths in ``jax.tree`` order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _sorted_paths(tree[k],
                                                               prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _sorted_paths(v, prefix + (i,))]
    return [prefix]


def compress_tree(grads: Any, method: str, ratio: float,
                  gen: torch.Generator) -> Any:
    """Apply a compressor leaf by leaf.  Each leaf gets a stream of its own
    (a seed drawn from ``gen`` in the reference's leaf order), as
    ``jax.random.split`` gives each leaf its key.  A ``None`` leaf (a zero
    gradient) stays ``None``: every compressor maps zero to zero."""
    if method == "none":
        return grads
    if method not in ("topk", "randk", "lowrank"):
        raise ValueError(f"unknown compression method {method!r}; "
                         f"known: none, topk, randk, lowrank")
    paths = _sorted_paths(grads)
    seeds = torch.randint(0, 2 ** 62, (len(paths),), generator=gen,
                          device=gen.device).tolist()
    seed_of = dict(zip(paths, seeds))

    def one(path, g):
        if g is None:
            return None
        if method == "topk":
            return topk_apply(g, ratio)
        leaf_gen = torch.Generator(device=gen.device).manual_seed(
            seed_of[path])
        if method == "randk":
            return randk_apply(g, ratio, leaf_gen)
        return lowrank_apply(g, max(1, int(ratio * 32)), leaf_gen)

    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, prefix + (i,)) for i, v in enumerate(tree)]
        return one(prefix, tree)

    return walk(grads)
