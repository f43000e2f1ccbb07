"""Depth-specialized SPB training steps (the single-device part of
``repro/dist/steps.py``).

For temporal SPB, :func:`build_spb_train_steps` makes one step per
snapped suffix depth; for ``temporal-mb`` one step that runs the whole
depth cycle as accumulated microbatches.  PyTorch runs eagerly, so a "step" is a plain
function: the depth decides which layers run under ``torch.no_grad()`` in
``lm.loss_fn``, and autograd then has no backward to run for them -- the
prefix's backward kernels are never launched and its activations are
never kept.

:func:`make_functional_train_step` and
:func:`make_functional_temporal_mb_step` are the same steps as pure
functions of ``(params, opt, step, batch)``: the gradients come from
``torch.func.vjp`` over the params tree instead of ``.grad``, so
``torch.func.vmap`` can batch them over a leading jobs axis
(``engine/fused.py``).  There a frozen leaf's gradient is a zero tensor
where autograd leaves ``None``; the optimizer treats the two alike.  The
backward runs under ``no_grad`` with ``retain_graph=False``, so it frees
the forward's activations as it goes, as ``loss.backward()`` does
(``torch.func.grad`` builds a differentiable backward that keeps them
all until it ends).

Every step takes the layer-recompute policy ``remat`` ('none', 'dots',
'full'; None: ``lm.REMAT``'s value), resolved when the step is built and
closed over: a CUDA graph bakes it in at capture, and a context variable
does not follow a step into another thread.  The eager steps run it as
``lm.loss_fn`` does (a checkpoint a live repeat).  A checkpoint's
saved-tensor hooks cannot run under ``torch.func``, so the functional
steps take 'full' as ``lm.swept_grads``, a sweep of ``torch.func.vjp``
over the live repeats; 'dots' has no such form yet and raises there.
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
                 spb_cfg: Optional[SPBConfig], scale: float = 1.0,
                 sched: Optional[torch.Tensor] = None, update: bool = True
                 ) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Collect the gradients (``None`` where autograd left none), compress
    them if ``tcfg.compression`` asks, run the optimizer (reading the
    schedule from ``sched`` when given, ``optim.apply_updates``) and
    advance the step.  With ``update=False`` the gradients are dropped and
    the state is left as it was: a CUDA graph's warm-up."""
    params = state["params"]
    if not update:
        tree_map(lambda p: setattr(p, "grad", None), params)
        return state, metrics

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
        spb_cfg=spb_cfg, sched=sched)
    state["step"] += 1
    return state, {**metrics, **opt_metrics}


def compression_generator(tcfg: TrainConfig, step: int) -> torch.Generator:
    """The compressors' generator at ``step``: a CPU generator seeded from
    ``(tcfg.seed, step)`` (the reference folds ``step`` into its key), so a
    step draws the same indices and projections on the card and the CPU."""
    seed = np.random.SeedSequence([tcfg.seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _accumulate(state: State, chunks, depths, cfg: ModelConfig,
                remat: str = "none"):
    """Backward of each chunk at its depth, the gradients accumulating in
    ``.grad``; returns the chunks' mean metrics."""
    metrics = None
    for chunk, depth in zip(chunks, depths):
        loss, mm = lm.loss_fn(state["params"], chunk, cfg, bwd_layers=depth,
                              remat=remat)
        loss.backward()
        mm = {k: v.detach() for k, v in mm.items()}
        metrics = mm if metrics is None else {
            k: metrics[k] + mm[k] for k in metrics}
    n = len(chunks)
    return metrics if n == 1 else {k: v * (1.0 / n) for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    spb_cfg: Optional[SPBConfig] = None, *,
                    depth: Optional[int] = None,
                    remat: Optional[str] = None) -> Callable:
    """A (state, batch) -> (state, metrics) step at SPB suffix ``depth``
    (None = full backprop), over ``tcfg.microbatches`` accumulated chunks,
    under the recompute policy ``remat``.  The state is updated in place;
    ``sched`` and ``update`` as :func:`_finish_step` takes them."""
    remat = lm.resolve_remat(remat)

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        m = max(1, tcfg.microbatches)
        chunks = _microbatches(batch, m) if m > 1 else [batch]
        metrics = _accumulate(state, chunks, [depth] * m, cfg, remat)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / m, sched=sched, update=update)

    return step


def make_temporal_mb_step(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig, *,
                          remat: Optional[str] = None) -> Callable:
    """One step over the whole depth cycle: the batch splits into
    ``len(cycle)`` microbatches, microbatch j backprops suffix depth
    ``depths[order[j]]``, and one optimizer step takes the mean gradient
    (``tcfg.microbatches`` is not used)."""
    remat = lm.resolve_remat(remat)
    schedule = spb_lib.make_schedule(cfg, spb_cfg)
    cycle = [schedule.depths[i] for i in schedule.order]

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        chunks = _microbatches(batch, len(cycle))
        metrics = _accumulate(state, chunks, cycle, cfg, remat)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / len(cycle), sched=sched,
                            update=update)

    return step


def _functional_step(cfg: ModelConfig, tcfg: TrainConfig,
                     spb_cfg: Optional[SPBConfig], depths,
                     remat: Optional[str]) -> Callable:
    """A pure (params, opt, step, batch) -> (params, opt, metrics) step:
    the batch splits into ``len(depths)`` microbatches, microbatch j
    backprops suffix depth ``depths[j]``, and the summed gradients, scaled
    by ``1 / len(depths)``, go through the compressor (if any) and the
    optimizer.  The optimizer updates ``params`` and ``opt`` in place and
    returns them; the metrics are 0-d tensors, so ``vmap`` stacks them.
    ``params`` are plain tensors (no ``requires_grad``).  ``sched`` and
    ``update`` as :func:`_finish_step` takes them.  ``remat`` 'full'
    takes the gradients from ``lm.swept_grads``; 'dots' raises."""
    n = len(depths)
    remat = lm.resolve_remat(remat)
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' in a functional (fused) step: the recompute runs "
            "there as a sweep of torch.func.vjp, which keeps no product "
            "outputs yet (ROADMAP.md Queue 1 B item 16); use 'full' or "
            "'none'")

    def grad_at(depth):
        if remat == "full":
            return lambda params, chunk: lm.swept_grads(
                params, chunk, cfg, bwd_layers=depth)

        def grad_fn(params, chunk):
            loss, vjp_fn, mm = torch.func.vjp(
                lambda p: lm.loss_fn(p, chunk, cfg, bwd_layers=depth),
                params, has_aux=True)
            with torch.no_grad():
                (g,) = vjp_fn(torch.ones_like(loss), retain_graph=False)
            return g, mm
        return grad_fn

    grad_at = [grad_at(d) for d in depths]

    def step(params, opt, step: int, batch, sched=None, update=True):
        chunks = _microbatches(batch, n) if n > 1 else [batch]
        grads = metrics = None
        for chunk, grad_fn in zip(chunks, grad_at):
            g, mm = grad_fn(params, chunk)
            if grads is None:
                grads, metrics = g, mm
            else:
                grads = tree_map(torch.add, grads, g)
                metrics = {k: metrics[k] + mm[k] for k in metrics}
        if n > 1:
            grads = tree_map(lambda t: t * (1.0 / n), grads)
            metrics = {k: v * (1.0 / n) for k, v in metrics.items()}
        if not update:
            return params, opt, metrics
        if tcfg.compression != "none":
            grads = compress.compress_tree(
                grads, tcfg.compression, tcfg.compression_ratio,
                compression_generator(tcfg, step))
        _, _, opt_metrics = optimizers.apply_updates(
            params, grads, opt, step, tcfg, cfg=cfg, spb_cfg=spb_cfg,
            sched=sched)
        return params, opt, {**metrics, **opt_metrics}

    return step


def make_functional_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                               spb_cfg: Optional[SPBConfig] = None, *,
                               depth: Optional[int] = None,
                               remat: Optional[str] = None) -> Callable:
    """:func:`make_train_step` as a pure (params, opt, step, batch) ->
    (params, opt, metrics) function over ``tcfg.microbatches`` chunks."""
    return _functional_step(cfg, tcfg, spb_cfg,
                            [depth] * max(1, tcfg.microbatches), remat)


def make_functional_temporal_mb_step(cfg: ModelConfig, tcfg: TrainConfig,
                                     spb_cfg: SPBConfig, *,
                                     remat: Optional[str] = None
                                     ) -> Callable:
    """:func:`make_temporal_mb_step` as a pure (params, opt, step, batch)
    -> (params, opt, metrics) function."""
    sched = spb_lib.make_schedule(cfg, spb_cfg)
    return _functional_step(cfg, tcfg, spb_cfg,
                            [sched.depths[i] for i in sched.order], remat)


def spb_step_keys(cfg: ModelConfig, spb_cfg: SPBConfig) -> list:
    """The step table's keys: always ``None`` (full backprop), plus each
    snapped depth of the cycle for ``temporal``, or ``"mb"`` (the whole
    cycle as accumulated microbatches) for ``temporal-mb``."""
    if spb_cfg.mode == "spatial":
        raise NotImplementedError(
            "SPB mode 'spatial' runs one depth per data-parallel worker and "
            "needs a process group of several GPUs; it comes with the "
            "multi-GPU slice (ROADMAP.md Queue 1 B item 11)")
    if spb_cfg.mode not in ("off", "temporal", "temporal-mb"):
        raise ValueError(f"unknown SPB mode {spb_cfg.mode!r}; known: off, "
                         f"temporal, temporal-mb, spatial")
    keys: list = [None]
    if spb_cfg.mode == "temporal":
        keys += sorted(set(spb_lib.snapped_depths(cfg, spb_cfg)))
    elif spb_cfg.mode == "temporal-mb":
        keys.append("mb")
    return keys


def build_spb_train_steps(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig, *, remat: Optional[str] = None
                          ) -> Dict[Any, Callable]:
    """Step functions keyed by :func:`spb_step_keys`: ``"mb"`` runs
    :func:`make_temporal_mb_step`, a depth :func:`make_train_step`, each
    under the recompute policy ``remat``."""
    remat = lm.resolve_remat(remat)
    return {k: make_temporal_mb_step(cfg, tcfg, spb_cfg, remat=remat)
            if k == "mb"
            else make_train_step(cfg, tcfg, spb_cfg, depth=k, remat=remat)
            for k in spb_step_keys(cfg, spb_cfg)}
