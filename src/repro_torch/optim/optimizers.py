"""Optimizers: SGD+momentum (the paper's setting) and AdamW, hand-rolled
(the counterpart of ``repro/optim/optimizers.py``; ``torch.optim.AdamW``
places its decay and eps differently).

  * Global-norm gradient clipping, then the SPB per-block scaling
    (``core/spb.py``).
  * Mixed precision: low-precision params keep f32 master copies in the
    optimizer state; all moments are f32.
  * A ``None`` gradient (a parameter the SPB step froze whole) counts as a
    zero gradient: its moments still decay and its weight decay still
    applies, exactly as with the zeros ``jax.grad`` returns.
  * ZeRO-1 (``shards=``, a tree like the params of
    ``dist/sharding.shard_slices`` entries): the optimizer state holds a
    rank's slice of each sharded leaf, and the update after the global
    norm (the clip, the SPB row scale, the moments, weight decay, the
    master) runs on that slice of the gradient and writes that slice of
    the parameter.  Every operation is elementwise, so a slice's numbers
    are bit for bit those of the whole leaf's update; the caller gathers
    the parameters (``dist/steps.py``).

Updates are in place: the moments, the master copies and the params are
overwritten, and ``apply_updates`` returns the same objects.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SPBConfig, TrainConfig
from repro_torch.core import spb as spb_lib
from repro_torch.tree import tree_leaves, tree_map


def lr_at(tcfg: TrainConfig, step: int) -> float:
    """Linear warmup then cosine decay to 10%."""
    warm = min(1.0, (step + 1) / max(tcfg.warmup_steps, 1))
    frac = min(max(step / max(tcfg.num_steps, 1), 0.0), 1.0)
    return tcfg.learning_rate * warm * (0.55 + 0.45 * math.cos(math.pi * frac))


def schedule_values(tcfg: TrainConfig, step: int) -> np.ndarray:
    """What a graphed step reads at ``step`` in place of the host scalars
    of :func:`apply_updates`: the learning rate and AdamW's inverse bias
    corrections, f32, as the card rounds a host scalar (a division by a
    host scalar is a product with its f32 reciprocal, taken in f64)."""
    t = step + 1.0
    return np.array([lr_at(tcfg, step), 1.0 / (1 - tcfg.beta1 ** t),
                     1.0 / (1 - tcfg.beta2 ** t)], np.float32)


def local(t, part):
    """A rank's slice of ``t`` (``part``: a ``dist/sharding.shard_slices``
    entry, ``(dim, start, length)``), a view; ``t`` itself for ``None`` and
    for a ``t`` that is already the slice (its ``dim`` is ``length``
    long: a whole leaf's is a multiple of it)."""
    if part is None or t is None or t.shape[part[0]] == part[2]:
        return t
    return t.narrow(*part)


def init_opt_state(params, tcfg: TrainConfig, shards=None) -> Dict[str, Any]:
    """Fresh optimizer state for ``params``; with ``shards``, of this
    rank's slice of each leaf only (built as such, never sliced from a
    whole state)."""
    if shards is not None:
        params = tree_map(local, params, shards)
    zeros = lambda p: tree_map(
        lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device), p)
    state: Dict[str, Any] = {}
    if tcfg.optimizer == "adamw":
        state["mu"] = zeros(params)
        state["nu"] = zeros(params)
    elif tcfg.optimizer == "sgdm":
        state["mom"] = zeros(params)
    else:
        raise ValueError(tcfg.optimizer)
    if any(t.dtype != torch.float32 for t in tree_leaves(params)):
        state["master"] = tree_map(
            lambda t: t.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves; a ``None`` leaf adds an
    explicit zero, so the sum rounds as it would with a zero gradient."""
    leaves = tree_leaves(tree)
    dev = next(g.device for g in leaves if g is not None)
    zero = torch.zeros((), device=dev)
    sq = [zero if g is None else g.float().square().sum() for g in leaves]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(params, grads, opt_state, step: int, tcfg: TrainConfig,
                  cfg: Optional[ModelConfig] = None,
                  spb_cfg: Optional[SPBConfig] = None, *,
                  sched: Optional[torch.Tensor] = None, shards=None,
                  gnorm: Optional[torch.Tensor] = None, rows=None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One optimizer step, in place.  ``grads`` matches ``params`` with
    ``None`` for a parameter that got no gradient.  Returns (params,
    opt_state, metrics).  With ``shards`` (ZeRO-1) ``opt_state`` holds this
    rank's slices, and only those slices of ``params`` are written.

    ``sched``: a device tensor holding :func:`schedule_values` of ``step``
    (a CUDA graph's static input, refilled before each replay), read in
    place of the host scalars a capture would bake in; the card gives the
    same bits either way.

    A pipeline stage's rank holds part of the model (``rows``: the first
    unit and count of its rows of each group, ``stage.StageMap.rows``):
    its ``gnorm`` is the norm over every stage, and the SPB scales of its
    rows are those rows' (``core/spb.scale_params_tree``)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    updated = params
    if shards is not None:          # views: the update writes through them
        grads = tree_map(local, grads, shards)
        updated = tree_map(local, params, shards)
    if tcfg.grad_clip > 0:
        clip = torch.clamp(tcfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
        grads = tree_map(lambda g: None if g is None else g.float() * clip,
                         grads)
    else:
        grads = tree_map(lambda g: None if g is None else g.float(), grads)

    # SPB weighted-average / per-block LR scaling (paper §2)
    if spb_cfg is not None and cfg is not None and spb_cfg.mode != "off":
        grads = spb_lib.scale_params_tree(grads, cfg, spb_cfg, shards, rows)

    if sched is None:
        lr = lr_at(tcfg, step)
    else:
        lr, inv_bc1, inv_bc2 = sched[0], sched[1], sched[2]
    master = opt_state.get("master", updated)

    if tcfg.optimizer == "adamw":
        t = step + 1.0
        b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

        def debias(mu, nu):
            if sched is None:
                return mu / bc1, nu / bc2
            return mu * inv_bc1, nu * inv_bc2

        def adamw(p, m, mu, nu, g):
            mu.mul_(b1)
            nu.mul_(b2)
            if g is not None:
                mu.add_(g, alpha=1 - b1)
                nu.add_(g * g, alpha=1 - b2)
            mu_hat, nu_hat = debias(mu, nu)
            upd = mu_hat / (torch.sqrt(nu_hat) + eps)
            m.sub_(lr * (upd + wd * m))
            if m is not p:
                p.copy_(m)

        tree_map(adamw, updated, master, opt_state["mu"], opt_state["nu"],
                 grads)
    else:  # sgdm (paper: SGD with momentum + 1e-4 weight decay)
        def sgdm(p, m, mom, g):
            mom.mul_(tcfg.momentum).add_(m, alpha=tcfg.weight_decay)
            if g is not None:
                mom.add_(g)
            m.sub_(lr * mom)
            if m is not p:
                p.copy_(m)

        tree_map(sgdm, updated, master, opt_state["mom"], grads)

    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(lr, dtype=torch.float32)
               if sched is None else lr}
    return params, opt_state, metrics
