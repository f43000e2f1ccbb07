"""Carry weights across from the JAX package.

Random initializers cannot match across frameworks, so a parity check
builds parameters with ``repro.models.lm.init_lm``, turns them into numpy
(``jax.tree.map(np.asarray, params)``) and hands the tree here.  The two
packages share one layout, so the bridge is a name-by-name copy that
raises on any missing, extra or mis-shaped leaf.  A serving grid's rank
holds its shards of the tensor-parallel layers and its share of each MoE
layer's experts (:func:`serve_params_from_numpy`).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.dist import sharding
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map


def _from_numpy(tree: Any, cfg: ModelConfig, device, lead: tuple) -> Any:
    """The port's params from a numpy tree in the JAX layout whose every
    leaf carries the leading dims ``lead`` before its own shape; raises on
    any missing, extra or mis-shaped leaf."""

    def copy(expected, got, path):
        if isinstance(expected, dict):
            if not isinstance(got, dict) or set(got) != set(expected):
                raise KeyError(f"{path or 'params'}: expected keys "
                               f"{sorted(expected)}, got "
                               f"{sorted(got) if isinstance(got, dict) else type(got).__name__}")
            return {k: copy(expected[k], got[k], f"{path}.{k}")
                    for k in expected}
        if isinstance(expected, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(expected):
                raise KeyError(f"{path}: expected a list of {len(expected)}")
            return [copy(e, g, f"{path}[{i}]")
                    for i, (e, g) in enumerate(zip(expected, got))]
        arr = np.asarray(got)
        want = lead + tuple(expected.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: expected shape {want}, got "
                             f"{tuple(arr.shape)}")
        return torch.tensor(arr.astype(np.float32), dtype=expected.dtype,
                            device=device)

    return copy(lm.param_shapes(cfg), tree, "")


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cpu") -> Any:
    """The port's params from a numpy tree in the JAX layout, as leaf
    tensors that require grad, each in the dtype that
    :func:`lm.param_shapes` gives it (the f32 SSM leaves stay f32 in a
    bf16 model)."""
    return tree_map(lambda t: t.requires_grad_(True),
                    _from_numpy(tree, cfg, device, ()))


def stacked_params_from_numpy(trees: Any, cfg: ModelConfig,
                              device="cpu") -> Any:
    """The port's stacked params (a leading jobs axis on every leaf, as
    ``engine.fused.FusedEngine`` holds them) from J numpy trees in the JAX
    layout, or from one such tree already stacked (the reference's
    ``FusedEngine`` state).  Plain tensors in the dtypes of
    :func:`params_from_numpy`; raises as it does on a mismatched leaf."""
    if isinstance(trees, dict):
        J = np.shape(tree_leaves(trees)[0])[0]
        return _from_numpy(trees, cfg, device, (J,))
    return tree_map(lambda *ts: torch.stack(ts),
                    *(_from_numpy(t, cfg, device, ()) for t in trees))


def serve_params_from_numpy(tree: Any, cfg: ModelConfig, model: tuple,
                            device="cpu", rules_overrides=None) -> Any:
    """One serving grid rank's params from the reference's whole tree
    (numpy, the JAX layout): ``model = (t, T)``; the rank takes its
    column/row shard of each attn/local mixer and dense FFN and its share
    of each MoE layer's experts, and every other leaf whole
    (``dist/sharding.serve_params_pspec`` under ``rules_overrides``: an
    attn/local mixer is whole where a ``kv_seq`` override takes
    ``model``).  Plain tensors (serving runs no backward); raises as
    :func:`params_from_numpy` does on a missing, extra or mis-shaped
    leaf."""
    t, T = model
    mesh = sharding.Mesh((1, T), ("data", "model"))
    with sharding.rules(rules_overrides):
        specs = sharding.serve_params_pspec(lm.param_shapes(cfg), cfg, mesh)
    share = sharding.grid_share(_from_numpy(tree, cfg, "cpu", ()), specs,
                                mesh, {"model": t})
    return tree_map(lambda w: w.to(device, copy=True), share)
