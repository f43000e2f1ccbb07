"""Depth-specialized SPB training steps (the single-device part of
``repro/dist/steps.py``).

For temporal SPB, :func:`build_spb_train_steps` makes one step per snapped
suffix depth; for ``temporal-mb`` one step that runs the whole depth cycle
as accumulated microbatches.  PyTorch runs eagerly, so a "step" is a plain
function: the depth decides which layers run under ``torch.no_grad()`` in
``lm.loss_fn``, and autograd then has no backward to run for them -- the
prefix's backward kernels are never launched and its activations are
never kept.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SPBConfig, TrainConfig
from repro_torch.core import compress
from repro_torch.core import spb as spb_lib
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map

State = Dict[str, Any]


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, device=None) -> State:
    """Params (leaf tensors requiring grad), optimizer state, step 0."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      lm.init_lm(gen, cfg, device))
    return state_from_params(params, tcfg)


def state_from_params(params, tcfg: TrainConfig) -> State:
    return {"params": params, "opt": optimizers.init_opt_state(params, tcfg),
            "step": 0}


def _microbatches(batch: Dict[str, torch.Tensor], m: int):
    """Split every leaf along the batch dim into ``m`` equal chunks."""
    size = next(iter(batch.values())).shape[0]
    if size % m:
        raise ValueError(f"batch size {size} not divisible by {m} microbatches")
    c = size // m
    return [{k: t[i * c:(i + 1) * c] for k, t in batch.items()}
            for i in range(m)]


def _finish_step(state: State, metrics, tcfg: TrainConfig, cfg: ModelConfig,
                 spb_cfg: Optional[SPBConfig], scale: float = 1.0
                 ) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Collect the gradients (``None`` where autograd left none), compress
    them if ``tcfg.compression`` asks, run the optimizer and advance the
    step."""
    params = state["params"]

    def take(p):
        g, p.grad = p.grad, None
        return g if g is None or scale == 1.0 else g * scale

    grads = tree_map(take, params)
    if tcfg.compression != "none":
        gen = compression_generator(tcfg, state["step"])
        grads = compress.compress_tree(grads, tcfg.compression,
                                       tcfg.compression_ratio, gen)
    _, _, opt_metrics = optimizers.apply_updates(
        params, grads, state["opt"], state["step"], tcfg, cfg=cfg,
        spb_cfg=spb_cfg)
    state["step"] += 1
    return state, {**metrics, **opt_metrics}


def compression_generator(tcfg: TrainConfig, step: int) -> torch.Generator:
    """The compressors' generator at ``step``: a CPU generator seeded from
    ``(tcfg.seed, step)`` (the reference folds ``step`` into its key), so a
    step draws the same indices and projections on the card and the CPU."""
    seed = np.random.SeedSequence([tcfg.seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _accumulate(state: State, chunks, depths, cfg: ModelConfig):
    """Backward of each chunk at its depth, the gradients accumulating in
    ``.grad``; returns the chunks' mean metrics."""
    metrics = None
    for chunk, depth in zip(chunks, depths):
        loss, mm = lm.loss_fn(state["params"], chunk, cfg, bwd_layers=depth)
        loss.backward()
        mm = {k: v.detach() for k, v in mm.items()}
        metrics = mm if metrics is None else {
            k: metrics[k] + mm[k] for k in metrics}
    n = len(chunks)
    return metrics if n == 1 else {k: v * (1.0 / n) for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    spb_cfg: Optional[SPBConfig] = None, *,
                    depth: Optional[int] = None) -> Callable:
    """A (state, batch) -> (state, metrics) step at SPB suffix ``depth``
    (None = full backprop), over ``tcfg.microbatches`` accumulated chunks.
    The state is updated in place."""

    def step(state: State, batch) -> Tuple[State, Dict[str, torch.Tensor]]:
        m = max(1, tcfg.microbatches)
        chunks = _microbatches(batch, m) if m > 1 else [batch]
        metrics = _accumulate(state, chunks, [depth] * m, cfg)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / m)

    return step


def make_temporal_mb_step(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig) -> Callable:
    """One step over the whole depth cycle: the batch splits into
    ``len(cycle)`` microbatches, microbatch j backprops suffix depth
    ``depths[order[j]]``, and one optimizer step takes the mean gradient
    (``tcfg.microbatches`` is not used)."""
    sched = spb_lib.make_schedule(cfg, spb_cfg)
    cycle = [sched.depths[i] for i in sched.order]

    def step(state: State, batch) -> Tuple[State, Dict[str, torch.Tensor]]:
        chunks = _microbatches(batch, len(cycle))
        metrics = _accumulate(state, chunks, cycle, cfg)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / len(cycle))

    return step


def build_spb_train_steps(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig) -> Dict[Any, Callable]:
    """Step functions keyed by suffix depth: always ``None`` (full
    backprop), plus one per snapped depth of the cycle for ``temporal``, or
    ``"mb"`` (the whole cycle as accumulated microbatches) for
    ``temporal-mb``."""
    if spb_cfg.mode == "spatial":
        raise NotImplementedError(
            "SPB mode 'spatial' runs one depth per data-parallel worker and "
            "needs a process group of several GPUs; it comes with the "
            "multi-GPU slice (ROADMAP.md Queue 1 B item 11)")
    if spb_cfg.mode not in ("off", "temporal", "temporal-mb"):
        raise ValueError(f"unknown SPB mode {spb_cfg.mode!r}; known: off, "
                         f"temporal, temporal-mb, spatial")
    steps: Dict[Any, Callable] = {
        None: make_train_step(cfg, tcfg, spb_cfg, depth=None)}
    if spb_cfg.mode == "temporal":
        for d in sorted(set(spb_lib.snapped_depths(cfg, spb_cfg))):
            steps[d] = make_train_step(cfg, tcfg, spb_cfg, depth=d)
    elif spb_cfg.mode == "temporal-mb":
        steps["mb"] = make_temporal_mb_step(cfg, tcfg, spb_cfg)
    return steps
