"""Structured Partial Backpropagation: depth schedules and the weighted
aggregation (the counterpart of ``repro/core/spb.py``).

Paper semantics (k workers, L layers): worker j backprops only through the
suffix of ceil(j*L/k) layers; the parameter server averages each layer's
gradient over the workers that computed it.  Temporally, the suffix depth
cycles over steps and layer block i receives i of k updates per cycle,
which per-block scaling of the update turns back into the paper's
weighted average.  Spatially (:func:`spatial_grads`), each rank of a data
group (``dist/group.DataGroup``) backpropagates its own depth and the
partial gradients are summed over the group and weighted per layer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.config import (ModelConfig, SPBConfig, combined_layer_groups,
                                layer_groups, snap_depth,
                                snap_depth_to_stages, total_layers)
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Depth schedules
# ---------------------------------------------------------------------------

def snapped_depths(cfg: ModelConfig, spb: SPBConfig) -> Tuple[int, ...]:
    """The k suffix depths, snapped up to scan-unit boundaries (stage
    boundaries when ``spb.pipeline_stages`` is set)."""
    raw = spb.depths(total_layers(cfg))
    if spb.pipeline_stages:
        return tuple(snap_depth_to_stages(cfg, d, spb.pipeline_stages)
                     for d in raw)
    return tuple(snap_depth(cfg, d) for d in raw)


def layer_contributors(cfg: ModelConfig, spb: SPBConfig) -> Tuple[int, ...]:
    """contributors[l] = number of depth levels whose suffix covers layer l
    (layer l, from the input, is covered by depth d iff l >= L - d)."""
    L = total_layers(cfg)
    depths = snapped_depths(cfg, spb)
    return tuple(sum(1 for d in depths if l >= L - d) for l in range(L))


@dataclasses.dataclass
class TemporalSchedule:
    """Cycles the k snapped depths over steps; supports warmup + rebalance."""
    depths: Tuple[int, ...]
    warmup_steps: int = 0
    order: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.order:
            # interleave deep and shallow so gradient staleness of early
            # layers is spread evenly through the cycle
            idx = sorted(range(len(self.depths)),
                         key=lambda i: (-self.depths[i], i))
            inter: List[int] = []
            lo, hi = 0, len(idx) - 1
            while lo <= hi:
                inter.append(idx[lo]); lo += 1
                if lo <= hi:
                    inter.append(idx[hi]); hi -= 1
            self.order = tuple(inter)

    @property
    def k(self) -> int:
        return len(self.depths)

    def depth_at(self, step: int) -> int:
        if step < self.warmup_steps:
            return max(self.depths)
        return self.depths[self.order[(step - self.warmup_steps) % self.k]]

    def rebalance(self, slow_positions: Sequence[int]) -> "TemporalSchedule":
        """Straggler mitigation: move the deepest (most expensive) cycle
        positions away from positions observed to be slow."""
        k = self.k
        slow = {p % k for p in slow_positions}
        by_cost = sorted(range(k), key=lambda i: -self.depths[i])
        positions = sorted(range(k), key=lambda p: (p in slow))  # fast first
        new_order = [0] * k
        for lvl, pos in zip(by_cost, positions):
            new_order[pos] = lvl
        return dataclasses.replace(self, order=tuple(new_order))


def make_schedule(cfg: ModelConfig, spb: SPBConfig) -> TemporalSchedule:
    return TemporalSchedule(snapped_depths(cfg, spb), spb.warmup_steps)


# ---------------------------------------------------------------------------
# Weighted aggregation (the paper's PS-side weighted average)
# ---------------------------------------------------------------------------

def group_layer_scales(cfg: ModelConfig, spb: SPBConfig
                       ) -> List[List[torch.Tensor]]:
    """Per-group, per-unit-position f32 scale vectors of shape (count,):
    k / contributors for layers with contributors > 0, else 0."""
    contrib = layer_contributors(cfg, spb)
    k = spb.k
    out: List[List[torch.Tensor]] = []
    off = 0
    for unit, count in combined_layer_groups(cfg):
        p = len(unit)
        per_unit = []
        for u in range(p):
            idxs = [off + r * p + u for r in range(count)]
            per_unit.append(torch.tensor(
                [k / contrib[i] if contrib[i] > 0 else 0.0 for i in idxs],
                dtype=torch.float32))
        out.append(per_unit)
        off += p * count
    return out


# (cfg, spb, device, dtype) -> group_layer_scales there: a step copies its
# scales to the card once, not every step (a CUDA graph cannot capture a
# copy from pageable host memory)
_PLACED: Dict[tuple, List[List[torch.Tensor]]] = {}


def placed_scales(cfg: ModelConfig, spb: SPBConfig, device: torch.device,
                   dtype: torch.dtype) -> List[List[torch.Tensor]]:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (cfg, spb, device, dtype)
    if key not in _PLACED:
        _PLACED[key] = [[s.to(device, dtype) for s in unit]
                        for unit in group_layer_scales(cfg, spb)]
    return _PLACED[key]


def _scale_rows(tree, scale, parts=None):
    """``tree``'s leaves times ``scale(device, dtype)`` row by row; a leaf
    that is a rank's slice on dim 0 (its ``parts`` entry, as
    ``dist/sharding.shard_slices`` gives it) takes its rows' scales."""
    if isinstance(tree, dict):
        return {k: _scale_rows(v, scale, None if parts is None else parts[k])
                for k, v in tree.items()}
    if tree is None:
        return None
    rows = scale(tree.device, tree.dtype)
    if parts is not None and parts[0] == 0:
        rows = rows.narrow(0, parts[1], parts[2])
    return tree * rows.reshape((-1,) + (1,) * (tree.dim() - 1))


def scale_params_tree(params: Dict[str, Any], cfg: ModelConfig,
                      spb: SPBConfig, shards=None, rows=None
                      ) -> Dict[str, Any]:
    """Apply SPB weighted-average scaling to a gradient tree shaped like the
    LM params (``None`` leaves stay ``None``).  An encoder-decoder's
    encoder is the first group of the combined stack, so its groups take
    the first scales and the decoder's the rest.  ``shards``: when the
    leaves are a rank's ZeRO-1 slices, where each lies
    (``dist/sharding.shard_slices``).  ``rows``: when the decoder's
    groups are a pipeline stage's rows, the ``(first unit, count)`` of
    each group it holds."""
    if spb.mode == "off" or not spb.lr_rescale:
        return params

    def scale_of(g, u):
        def scale(dev, dt):
            out = placed_scales(cfg, spb, dev, dt)[g][u]
            if rows is not None and g >= first:
                out = out.narrow(0, *rows[g - first])
            return out
        return scale

    def scaled(groups, first, parts):
        return [[_scale_rows(up, scale_of(g, u),
                             None if parts is None else parts[g - first][u])
                 for u, up in enumerate(gp)]
                for g, gp in enumerate(groups, first)]

    out = dict(params)
    first = 0
    if cfg.enc_layers:
        out["enc"] = dict(params["enc"], groups=scaled(
            params["enc"]["groups"][:1], 0,
            None if shards is None else shards["enc"]["groups"]))
        first = 1
    out["groups"] = scaled(params["groups"], first,
                           None if shards is None else shards["groups"])
    return out


# ---------------------------------------------------------------------------
# Spatial (paper-faithful) aggregation over a data group
# ---------------------------------------------------------------------------

def row_layers(cfg: ModelConfig):
    """Yields (group, unit position, the flat layer index of each row) for
    the stacked leaves of the decoder's stack."""
    off = 0
    for g, (unit, count) in enumerate(layer_groups(cfg)):
        p = len(unit)
        for u in range(p):
            yield g, u, [off + r * p + u for r in range(count)]
        off += p * count


# (cfg, spb, n, device) -> spatial_grads' row scales there, placed once
_SPATIAL: Dict[tuple, Dict[Tuple[int, int], torch.Tensor]] = {}


def _spatial_scales(cfg: ModelConfig, spb: SPBConfig, n: int,
                    device: torch.device) -> Dict[Tuple[int, int],
                                                  torch.Tensor]:
    """Per (group, unit position): each row's ``1 / (contributors * n /
    k)``, f32, on ``device``."""
    key = (cfg, spb, n, device)
    if key not in _SPATIAL:
        contrib = layer_contributors(cfg, spb)
        groups_per_layer = n / spb.k
        _SPATIAL[key] = {
            (g, u): torch.tensor(
                [1.0 / (contrib[i] * groups_per_layer) if contrib[i] > 0
                 else 0.0 for i in idxs], dtype=torch.float32, device=device)
            for g, u, idxs in row_layers(cfg)}
    return _SPATIAL[key]


def spatial_grads(loss: torch.Tensor, grads: Dict[str, Any], *, group,
                  spb: SPBConfig, cfg: ModelConfig):
    """The paper's weighted aggregation of the ranks' partial gradients:
    ``loss`` (any shape) is averaged over ``group`` (a
    ``dist/group.DataGroup``), every leaf of ``grads`` is summed over it
    (in place), each row of a layer's stacked leaf is then scaled by
    ``1 / (contributors[l] * n / k)`` (0 where no level covers layer l:
    ``contributors[l] * n / k`` ranks computed it), and the other leaves
    (``embed``, ``final_norm``: every rank computes them) are divided by
    n.  Every rank hands over the same leaves in the same order: a frozen
    leaf's gradient is a zero tensor, not ``None``.  Returns (loss,
    grads)."""
    if cfg.enc_layers:
        raise ValueError("spatial SPB supports decoder-only stacks")
    n = group.size
    loss = group.all_reduce(loss.detach().clone()) / n
    tree_map(group.all_reduce, grads)
    out = {key: tree_map(lambda t: t / n, v)
           for key, v in grads.items() if key != "groups"}
    out["groups"] = [
        [_scale_rows(up, lambda dev, dt, g=g, u=u: _spatial_scales(
            cfg, spb, n, dev)[g, u].to(dt)) for u, up in enumerate(gp)]
        for g, gp in enumerate(grads["groups"])]
    return loss, out


def subgroup_allreduce(x: torch.Tensor, group, contributors: int
                       ) -> torch.Tensor:
    """Sum ``x`` in place over the last ``contributors`` ranks of
    ``group`` only, the ones that computed this block (their subgroup,
    ``DataGroup.make_subgroups``); the identity on the others, whose
    value the caller keeps.  Over all ranks when ``contributors`` covers
    the group."""
    return group.all_reduce(x, contributors)


# ---------------------------------------------------------------------------
# Estimator used by the theory tests (Lemma 7.3 structure)
# ---------------------------------------------------------------------------

def spb_estimator(per_worker_block_grads: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """The paper's parameter-server estimate from per-worker per-block
    gradients ``(k, L, ...)``: worker j (from 0) contributes the blocks
    l >= L - ceil((j+1) L / k), and each block is the mean of its
    contributions."""
    kk, L = per_worker_block_grads.shape[:2]
    if kk != k:
        raise ValueError(f"{kk} workers' gradients for k={k}")
    out = torch.zeros_like(per_worker_block_grads[0])
    for l in range(L):
        c = 0
        acc = torch.zeros_like(per_worker_block_grads[0, l])
        for j in range(k):
            if l >= L - math.ceil((j + 1) * L / k):
                acc = acc + per_worker_block_grads[j, l]
                c += 1
        out[l] = acc / max(c, 1)
    return out
