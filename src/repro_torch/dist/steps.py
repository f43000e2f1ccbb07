"""Depth-specialized SPB training steps (the counterpart of
``repro/dist/steps.py``).

For temporal SPB, :func:`build_spb_train_steps` makes one step per
snapped suffix depth; for ``temporal-mb`` one step that runs the whole
depth cycle as accumulated microbatches; for ``spatial`` one step in
which each rank of a data group backpropagates its own depth
(:func:`make_spatial_step`).  PyTorch runs eagerly, so a "step" is a plain
function: the depth decides which layers run under ``torch.no_grad()`` in
``lm.loss_fn``, and autograd then has no backward to run for them -- the
prefix's backward kernels are never launched and its activations are
never kept.

Under a data group of several ranks (``dist/group.DataGroup``) each rank
runs the step on its rows of the global batch.  ``off``, ``temporal`` and
``temporal-mb`` then average the gradients over the group before the
optimizer (a sum, then ``/ n``), and only what has a gradient: no leaf
that the depth froze whole and, of a group's stacked leaf that it split,
only the live rows.  That is what GSPMD emits for the reference's
temporal step, where the frozen prefix has no gradient and so no
collective.  The metrics are averaged too.  Every rank then runs the same
optimizer update on the same numbers, so the replicas stay equal.

With ZeRO-1 (``shards=``, each leaf's slice of this rank from
``dist/sharding.shard_slices``; ``engine.SPBEngine(zero1=True)``, the
default, passes them) the optimizer state holds this rank's slices: after
the same all-reduce and the same global norm, each rank updates its slice
of every sharded leaf (``optim/optimizers.apply_updates``) and the
parameters are then all-gathered (``DataGroup.all_gather``), one call a
sharded leaf.  Every rank ends the step with the parameters a replicated
group computes, bit for bit.  The gradients are not reduce-scattered: the
reference's plain step keeps them replicated too (its ZeRO-2 is a
pipeline knob, :func:`make_pipeline_train_step`'s ``zero2``).

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
steps take 'full' and 'dots' as ``lm.swept_grads``, a sweep of
``torch.func.vjp`` over the live repeats ('dots' replaying the product
outputs its forward kept).

On a ``(data, model)`` grid (``dist/group.GridGroup``; ``model=`` its
``ModelGroup``, ``group=`` its ``DataGroup``) a MoE layer's experts are
sharded over ``model`` and its tokens exchanged there
(``models/moe.moe_fwd_ep``); everything else runs replicated on the T
ranks of a data index.  The gradients of a MoE layer's router and shared
expert are then each model rank's part, so the step sums them over the
model group once (one all-reduce of their live parts, flattened, in f32),
before it averages every gradient over the data group as above.  The
clip norm counts the experts' squares summed over the model group and
every other leaf's once (:func:`_grid_norm`), so it is the norm of the
whole gradient; the model ranks of a data index then run the same update
on the same numbers, and their replicated leaves stay bit-identical.
With ``tcfg.compression`` the experts are all-gathered over the model
group first, so the compressor sees the logical tree as one process does
(:func:`_grid_compressed`), and the norm is the compressed tree's.

:func:`make_pipeline_train_step` runs the stack as a pipeline: each rank
of a ``dist/group.PipeGroup`` is a stage (or, with tensor parallelism, a
model shard of one), interpreting a ``dist/pipeline/schedules`` table
(GPipe or 1F1B) with ``dist/pipeline/runtime.run_schedule``; the SPB
depth becomes a stage truncation point, and the stages below it run
forward only.  :func:`build_pipeline_train_steps` is its per-depth table.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, SPBConfig, TrainConfig
from repro_torch.core import compress
from repro_torch.core import spb as spb_lib
from repro_torch.dist import sharding
from repro_torch.dist.group import DataGroup
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

State = Dict[str, Any]


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, device=None, shards=None) -> State:
    """Params (leaf tensors requiring grad), optimizer state (of this
    rank's slices with ``shards``), step 0."""
    params = tree_map(lambda t: t.requires_grad_(True),
                      lm.init_lm(gen, cfg, device))
    return state_from_params(params, tcfg, shards)


def state_from_params(params, tcfg: TrainConfig, shards=None) -> State:
    return {"params": params,
            "opt": optimizers.init_opt_state(params, tcfg, shards),
            "step": 0}


def train_state_shapes(cfg: ModelConfig, tcfg: TrainConfig) -> State:
    """The whole train state as meta tensors (the counterpart of the
    reference's ``jax.eval_shape`` of its initial state), allocating
    nothing; the step is the int 0."""
    return state_from_params(lm.param_shapes(cfg), tcfg)


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
                 sched: Optional[torch.Tensor] = None, update: bool = True,
                 group=None, depth: Optional[int] = None, shards=None,
                 grid: Optional["_Grid"] = None
                 ) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Collect the gradients (``None`` where autograd left none), sum the
    MoE layers' partial ones over the ``grid``'s model group when there is
    one, average them and the metrics over ``group`` when it has several
    ranks (the live part at suffix ``depth``, the deepest the step ran),
    then :func:`_apply` them (to this rank's ZeRO-1 slices with
    ``shards``; on a grid with the grid's norm).  With ``update=False`` the
    gradients are dropped and the state is left as it was: a CUDA graph's
    warm-up."""
    params = state["params"]
    if not update:
        tree_map(lambda p: setattr(p, "grad", None), params)
        return state, metrics

    def take(p):
        g, p.grad = p.grad, None
        return g if g is None or scale == 1.0 else g * scale

    grads = tree_map(take, params)
    if grid is not None:
        _sum_partials(_live_parts(grads, cfg, depth, grid.partial),
                      grid.model)
    if group is not None and group.size > 1:
        metrics = _average(group, metrics)
        n = group.size
        for part in _live_parts(grads, cfg, depth):
            group.all_reduce(part).div_(n)
    if grid is None:
        grads, gnorm = _compressed(grads, tcfg, state["step"]), None
    elif tcfg.compression != "none":
        grads, gnorm = _grid_compressed(grads, tcfg, grid, state["step"],
                                        1 if group is None else group.size)
    else:
        gnorm = _grid_norm(grads, grid.roles, grid.model)
    return _apply(state, grads, metrics, tcfg, cfg, spb_cfg, sched,
                  group=group, shards=shards, gnorm=gnorm)


class _Grid(NamedTuple):
    """A step's ``(data, model)`` grid: its model group of T > 1 ranks,
    each param leaf's role (:func:`ep_roles`), which leaves are partial,
    and the params' whole shapes (meta tensors)."""
    model: Any
    roles: Any
    partial: Any
    shapes: Any


def _grid(cfg: ModelConfig, model) -> Optional[_Grid]:
    """The step's grid, or None without a model group of several ranks."""
    if model is None or model.size <= 1:
        return None
    roles = ep_roles(cfg)
    return _Grid(model, roles, tree_map(lambda r: r == "partial", roles),
                 lm.param_shapes(cfg))


def _expert_dim(g: torch.Tensor, whole, T: int) -> int:
    """The dim on which ``g`` holds a share of the expert leaf shaped
    ``whole`` (the one dim where they differ, ``T`` shares long)."""
    dims = [i for i in range(g.dim()) if g.shape[i] != whole.shape[i]]
    if len(dims) != 1 or g.shape[dims[0]] * T != whole.shape[dims[0]]:
        raise ValueError(f"an expert share {tuple(g.shape)} of "
                         f"{tuple(whole.shape)} over {T} ranks")
    return dims[0]


def _grid_compressed(grads, tcfg: TrainConfig, grid: _Grid, step: int,
                     n_data: int):
    """Compression on a ``(data, model)`` grid, as one process compresses
    the logical tree: the expert leaves (this rank's share of each MoE
    layer's experts) are all-gathered over the model group, the whole
    tree (the partial sums and the data average already taken) goes
    through :func:`compression_generator`'s draw at ``step``, and the
    rank keeps its experts of the result.  Returns (its share, the norm
    of the whole compressed tree), the reference clipping the compressed
    tree.  The costs go to :data:`COMPRESSION_SINKS` (a world-wide
    gather: this rank's experts from every one of the ``n_data`` x T
    ranks)."""
    model = grid.model
    T = model.size
    device = next(g.device for g in tree_leaves(grads) if g is not None)
    own = 0

    def whole(g, role, shape):
        nonlocal own
        if g is None or role != "expert":
            return g
        own += g.numel() * g.element_size()
        return model.all_gather(g.contiguous(), _expert_dim(g, shape, T))

    _sync(device)
    t0 = time.perf_counter()
    tree = tree_map(whole, grads, grid.roles, grid.shapes)
    _sync(device)
    out = _compress_timed(tree, tcfg, step, device,
                          time.perf_counter() - t0, own * (T - 1),
                          own * (n_data * T - 1))
    del tree

    def share(c, g, role, shape):
        if c is None or role != "expert":
            return c
        dim = _expert_dim(g, shape, T)
        n = g.shape[dim]
        return c.narrow(dim, model.rank * n, n).contiguous()

    return (tree_map(share, out, grads, grid.roles, grid.shapes),
            optimizers.global_norm(out))


def ep_roles(cfg: ModelConfig):
    """Per leaf of ``cfg``'s params, its role on a ``(data, model)`` grid:
    ``"expert"`` (a MoE layer's ``wg``/``wu``/``wd``, sharded over
    ``model``), ``"partial"`` (its router and shared expert, whose
    gradients are each model rank's part) or ``None`` (replicated, whole
    gradients on every rank)."""
    def role(keys, t):
        if "ffn" not in keys:
            return None
        rest = keys[keys.index("ffn") + 1:]
        if rest[0] in ("router", "shared"):
            return "partial"
        if rest[0] in ("wg", "wu", "wd") and t.dim() >= 4:
            return "expert"
        return None
    return tree_map_with_path(role, lm.param_shapes(cfg))


def _sum_partials(parts: list, model) -> None:
    """Sum ``parts`` (views of the gradients) over the model group in
    place: one all-reduce of them flattened, in f32."""
    if not parts:
        return
    flat = model.all_reduce(torch.cat([t.reshape(-1).float()
                                       for t in parts]))
    off = 0
    for t in parts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def _grid_norm(grads, roles, model) -> torch.Tensor:
    """The norm of the whole gradient on a ``(data, model)`` grid: the
    experts' sum of squares (each rank holds its share) summed over the
    model group, plus every other leaf's once (every rank holds them
    whole, alike)."""
    leaves = tree_leaves(grads)
    dev = next(g.device for g in leaves if g is not None)
    sq = {"expert": torch.zeros((), device=dev),
          None: torch.zeros((), device=dev)}
    for g, role in zip(leaves, tree_leaves(roles)):
        if g is not None:
            key = "expert" if role == "expert" else None
            sq[key] = sq[key] + g.float().square().sum()
    experts = model.all_reduce(sq["expert"].reshape(1))[0]
    return torch.sqrt(experts + sq[None])


def _average(group, metrics: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """The metrics' means over ``group``, in one all-reduce."""
    keys = sorted(metrics)
    both = group.all_reduce(torch.stack([metrics[k].detach().float()
                                         for k in keys])) / group.size
    return dict(zip(keys, both.unbind()))


def _live_parts(grads, cfg: ModelConfig, depth: Optional[int],
                select=None) -> list:
    """The parts of ``grads`` that a step at suffix ``depth`` can make
    nonzero, in a fixed order: every leaf that has a gradient, and of a
    group's stacked leaf only the rows ``depth`` left live, after the
    frozen ones (``lm.frozen_units``); only the leaves ``select`` (a tree
    of bools like ``grads``) marks, if given.  Views, so reducing them in
    place reduces the gradients."""
    frozen = lm.frozen_units(cfg, depth)
    if select is None:
        select = tree_map(lambda _: True, grads)
    parts = []

    def add(tree, sel, lo: int = 0):
        for t, on in zip(tree_leaves(tree), tree_leaves(sel)):
            if on and t is not None and t.shape[0] > lo:
                parts.append(t[lo:] if lo else t)

    def stack(tree, sel, key):
        for key2, v in tree.items():
            if key2 == "groups":
                for gp, sp, q in zip(v, sel[key2], frozen[key]):
                    add(gp, sp, q)
            else:
                add(v, sel[key2])

    stack({k: v for k, v in grads.items() if k != "enc"}, select, "groups")
    if "enc" in grads:
        stack(grads["enc"], select["enc"], "enc")
    return parts


def _apply(state: State, grads, metrics, tcfg: TrainConfig,
           cfg: ModelConfig, spb_cfg: Optional[SPBConfig],
           sched: Optional[torch.Tensor] = None, *, group=None, shards=None,
           gnorm: Optional[torch.Tensor] = None
           ) -> Tuple[State, Dict[str, torch.Tensor]]:
    """Run the optimizer on ``grads`` (compressed already, if
    ``tcfg.compression`` asks: :func:`_compressed`), reading the schedule
    from ``sched`` when given and the clip norm from ``gnorm`` when given
    (``optim.apply_updates``), and advance the step.  With ``shards`` the
    optimizer updates this rank's slices, and each sharded parameter is
    then all-gathered over ``group``."""
    _, _, opt_metrics = optimizers.apply_updates(
        state["params"], grads, state["opt"], state["step"], tcfg, cfg=cfg,
        spb_cfg=spb_cfg, sched=sched, shards=shards, gnorm=gnorm)
    if shards is not None:
        with torch.no_grad():
            for p, part in zip(tree_leaves(state["params"]),
                               tree_leaves(shards,
                                           is_leaf=sharding.is_slice)):
                if part is not None:
                    group.all_gather(p.detach(), part[0])
    state["step"] += 1
    return state, {**metrics, **opt_metrics}


def _compressed(grads, tcfg: TrainConfig, step: int):
    """``grads`` through ``tcfg.compression``'s compressor with the
    one-process draw at ``step`` (:func:`compression_generator`); as they
    are without one."""
    if tcfg.compression == "none":
        return grads
    return compress.compress_tree(grads, tcfg.compression,
                                  tcfg.compression_ratio,
                                  compression_generator(tcfg, step))


def compression_generator(tcfg: TrainConfig, step: int) -> torch.Generator:
    """The compressors' generator at ``step``: a CPU generator seeded from
    ``(tcfg.seed, step)`` (the reference folds ``step`` into its key), so a
    step draws the same indices and projections on the card and the CPU."""
    seed = np.random.SeedSequence([tcfg.seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _accumulate(state: State, chunks, depths, cfg: ModelConfig,
                remat: str = "none", ep=None):
    """Backward of each chunk at its depth (the experts sharded over the
    model group ``ep``, if any), the gradients accumulating in ``.grad``;
    returns the chunks' mean metrics."""
    metrics = None
    for chunk, depth in zip(chunks, depths):
        loss, mm = lm.loss_fn(state["params"], chunk, cfg, bwd_layers=depth,
                              remat=remat, ep=ep)
        loss.backward()
        mm = {k: v.detach() for k, v in mm.items()}
        metrics = mm if metrics is None else {
            k: metrics[k] + mm[k] for k in metrics}
    n = len(chunks)
    return metrics if n == 1 else {k: v * (1.0 / n) for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    spb_cfg: Optional[SPBConfig] = None, *,
                    depth: Optional[int] = None,
                    remat: Optional[str] = None, group=None,
                    shards=None, model=None) -> Callable:
    """A (state, batch) -> (state, metrics) step at SPB suffix ``depth``
    (None = full backprop), over ``tcfg.microbatches`` accumulated chunks,
    under the recompute policy ``remat``, averaged over the data group
    ``group`` when it has several ranks, the optimizer state this rank's
    ZeRO-1 slices with ``shards``, the experts sharded over the grid's
    model group ``model`` when given.  The state is updated in place;
    ``sched`` and ``update`` as :func:`_finish_step` takes them."""
    remat = lm.resolve_remat(remat)
    grid = _grid(cfg, model)

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        m = max(1, tcfg.microbatches)
        chunks = _microbatches(batch, m) if m > 1 else [batch]
        metrics = _accumulate(state, chunks, [depth] * m, cfg, remat, model)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / m, sched=sched, update=update,
                            group=group, depth=depth, shards=shards,
                            grid=grid)

    return step


def _mb_cycle(cfg: ModelConfig, spb_cfg: SPBConfig) -> list:
    """The temporal-mb step's depths, one a microbatch, in order."""
    schedule = spb_lib.make_schedule(cfg, spb_cfg)
    return [schedule.depths[i] for i in schedule.order]


def make_temporal_mb_step(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig, *,
                          remat: Optional[str] = None, group=None,
                          shards=None, model=None) -> Callable:
    """One step over the whole depth cycle: the batch splits into
    ``len(cycle)`` microbatches, microbatch j backprops suffix depth
    ``depths[order[j]]``, and one optimizer step takes the mean gradient
    (``tcfg.microbatches`` is not used), averaged over ``group``, summed
    over ``model`` and applied to ``shards`` as :func:`make_train_step`
    does."""
    remat = lm.resolve_remat(remat)
    cycle = _mb_cycle(cfg, spb_cfg)
    grid = _grid(cfg, model)

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        chunks = _microbatches(batch, len(cycle))
        metrics = _accumulate(state, chunks, cycle, cfg, remat, model)
        return _finish_step(state, metrics, tcfg, cfg, spb_cfg,
                            scale=1.0 / len(cycle), sched=sched,
                            update=update, group=group, depth=max(cycle),
                            shards=shards, grid=grid)

    return step


def make_spatial_step(cfg: ModelConfig, tcfg: TrainConfig,
                      spb_cfg: SPBConfig, *, group,
                      remat: Optional[str] = None, shards=None) -> Callable:
    """Spatial SPB, the paper's own form: rank r of ``group`` (a
    ``dist/group.DataGroup``; its size n may be 1) backpropagates suffix
    depth ``snapped_depths[r % k]`` on its rows, and
    ``core/spb.spatial_grads`` sums the partial gradients over the group
    and weights them per layer (the deepest rank gates the step).  With
    ``spb_cfg.subgroup_reduce`` each layer row is then re-reduced over its
    contributors (:func:`_subgroup_rereduce`).  The weighted average is
    the whole of the SPB scaling, so the optimizer does not rescale again
    (``lr_rescale`` off), and compression, if any, applies to the
    aggregate, as in the reference.  Its metrics are the loss and xent
    averaged over the group and a zero ``moe_aux``, as the reference's.
    With ``shards`` the optimizer updates this rank's ZeRO-1 slices
    (:func:`_apply`).

    The reference weights each layer as if each of the k levels ran on
    n / k ranks, which is exact when k divides n; otherwise the levels
    ``r % k`` never reaches go unrun and the layers that only they cover
    get no gradient, in both packages."""
    remat = lm.resolve_remat(remat)
    depth = spb_lib.snapped_depths(cfg, spb_cfg)[group.rank % spb_cfg.k]
    no_rescale = dataclasses.replace(spb_cfg, lr_rescale=False)
    if spb_cfg.subgroup_reduce:
        # new_group is collective: every rank makes these here, in order
        group.make_subgroups(_rereduce_counts(cfg, spb_cfg, group.size))

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        loss, mm = lm.loss_fn(params, batch, cfg, bwd_layers=depth,
                              remat=remat)
        loss.backward()
        if not update:
            tree_map(lambda p: setattr(p, "grad", None), params)
            return state, {k: v.detach() for k, v in mm.items()}

        def take(p):        # every rank reduces the same leaves
            g, p.grad = p.grad, None
            return torch.zeros_like(p) if g is None else g

        both, grads = spb_lib.spatial_grads(
            torch.stack([loss.detach(), mm["xent"].detach()]),
            tree_map(take, params), group=group, spb=spb_cfg, cfg=cfg)
        if spb_cfg.subgroup_reduce:
            grads = _subgroup_rereduce(grads, cfg, spb_cfg, group)
        metrics = {"loss": both[0], "xent": both[1],
                   "moe_aux": torch.zeros((), device=both.device)}
        return _apply(state, _compressed(grads, tcfg, state["step"]),
                      metrics, tcfg, cfg, no_rescale, sched, group=group,
                      shards=shards)

    return step


def _rereduce_counts(cfg: ModelConfig, spb_cfg: SPBConfig, n: int) -> list:
    """Per flat layer: the ranks its re-reduce runs over, its
    contributors ``contributors[l] * max(1, n // k)`` kept within [1, n]."""
    per_level = max(1, n // spb_cfg.k)
    return [min(max(c * per_level, 1), n)
            for c in spb_lib.layer_contributors(cfg, spb_cfg)]


def _subgroup_rereduce(grads, cfg: ModelConfig, spb_cfg: SPBConfig, group):
    """The reference's wiring of ``subgroup_allreduce``: each row of a
    layer's stacked leaf is re-reduced over the last ``c`` ranks only, its
    contributor count (:func:`_rereduce_counts`), so that a prefix row
    moves fewer wire bytes.

    The values are already summed, weighted and equal on every rank after
    ``spatial_grads``, so the re-reduce must leave them so on every rank:
    contributors feed ``t / c``, whose subgroup sum restores ``t``, and
    the other ranks, outside that subgroup, keep ``t`` undivided (dividing
    everywhere would leave ``t / c`` on rank 0).  A row with one
    contributor is left alone.  Because it follows a full sum, it adds
    wire bytes instead of cutting them, as the reference's does."""
    n = group.size
    counts = _rereduce_counts(cfg, spb_cfg, n)
    for g, u, layers in spb_lib.row_layers(cfg):
        for t in tree_leaves(grads["groups"][g][u]):
            for r, layer in enumerate(layers):
                c = counts[layer]
                if c > 1 and group.rank >= n - c:
                    row = t[r] / c
                    spb_lib.subgroup_allreduce(row, group, c)
                    t[r].copy_(row)
    return grads


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
    ``update`` as :func:`_finish_step` takes them.  ``remat`` 'full' or
    'dots' takes the gradients from ``lm.swept_grads``."""
    n = len(depths)
    remat = lm.resolve_remat(remat)

    def grad_at(depth):
        if remat != "none":
            return lambda params, chunk: lm.swept_grads(
                params, chunk, cfg, bwd_layers=depth, remat=remat)

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
        _, _, opt_metrics = optimizers.apply_updates(
            params, _compressed(grads, tcfg, step), opt, step, tcfg,
            cfg=cfg, spb_cfg=spb_cfg, sched=sched)
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
    return _functional_step(cfg, tcfg, spb_cfg, _mb_cycle(cfg, spb_cfg), remat)


def spb_step_keys(cfg: ModelConfig, spb_cfg: SPBConfig) -> list:
    """The step table's keys: always ``None`` (full backprop; for
    ``spatial`` the one step, whose depth is the rank's), plus each
    snapped depth of the cycle for ``temporal``, or ``"mb"`` (the whole
    cycle as accumulated microbatches) for ``temporal-mb``."""
    if spb_cfg.mode not in ("off", "temporal", "temporal-mb", "spatial"):
        raise ValueError(f"unknown SPB mode {spb_cfg.mode!r}; known: off, "
                         f"temporal, temporal-mb, spatial")
    keys: list = [None]
    if spb_cfg.mode == "temporal":
        keys += sorted(set(spb_lib.snapped_depths(cfg, spb_cfg)))
    elif spb_cfg.mode == "temporal-mb":
        keys.append("mb")
    return keys


def refuse_on_grid(spb_cfg: SPBConfig, model) -> None:
    """What a ``(data, model)`` grid of T > 1 model ranks refuses:
    spatial SPB.  The reference's spatial step is a ``shard_map`` over
    ``data`` around the whole loss, and ``moe_fwd_ep``'s ``shard_map`` over
    ``model`` inside it does not lower there (a reshape of 2048 elements
    into 4096 on a (2, 2) mesh)."""
    if model is None or model.size <= 1:
        return
    if spb_cfg.mode == "spatial":
        raise NotImplementedError(
            "SPB mode 'spatial' on a (data, model) grid: the reference's "
            "per-worker step (a shard_map over 'data') does not lower with "
            "moe_fwd_ep's shard_map over 'model' inside it; use "
            "'temporal', 'temporal-mb' or 'off'")


def build_spb_train_steps(cfg: ModelConfig, tcfg: TrainConfig,
                          spb_cfg: SPBConfig, *, remat: Optional[str] = None,
                          group=None, model=None) -> Dict[Any, Callable]:
    """Step functions keyed by :func:`spb_step_keys`, each under the
    recompute policy ``remat`` over the data group ``group`` (None: one
    rank) and the grid's model group ``model`` (None: none): for
    ``spatial`` ``{None:`` :func:`make_spatial_step` ``}``; otherwise
    ``"mb"`` runs :func:`make_temporal_mb_step`, a depth
    :func:`make_train_step`."""
    remat = lm.resolve_remat(remat)
    refuse_on_grid(spb_cfg, model)
    if spb_cfg.mode == "spatial":
        return {None: make_spatial_step(cfg, tcfg, spb_cfg, remat=remat,
                                        group=group or DataGroup())}
    return {k: make_temporal_mb_step(cfg, tcfg, spb_cfg, remat=remat,
                                     group=group, model=model)
            if k == "mb"
            else make_train_step(cfg, tcfg, spb_cfg, depth=k, remat=remat,
                                 group=group, model=model)
            for k in spb_step_keys(cfg, spb_cfg)}


# ---------------------------------------------------------------------------
# Pipelined SPB: the schedule-driven pipeline-parallel step
# ---------------------------------------------------------------------------

def check_pipeline_knobs(cfg: ModelConfig, tensor_parallel: int,
                         sequence_parallel: bool) -> int:
    """The reference's checks of a pipeline step's tensor-parallel knobs,
    with its texts; returns the tensor-parallel degree (1 for off)."""
    from repro_torch.dist.pipeline import stage as stage_lib
    tp = int(tensor_parallel) if tensor_parallel else 1
    if tp > 1:
        stage_lib.check_tensor_parallel_compatible(cfg, tp)
    if sequence_parallel and tp <= 1:
        raise ValueError("sequence_parallel requires tensor_parallel > 1")
    return tp


def refuse_pipeline_knobs(tensor_parallel, sequence_parallel: bool,
                          zero2: bool) -> None:
    """The reference's refusal of the pipeline's knobs outside a pipeline
    session."""
    if tensor_parallel not in (None, 0, 1) or sequence_parallel or zero2:
        raise ValueError("tensor_parallel / sequence_parallel / zero2 are "
                         "pipeline-session knobs")


def make_pipeline_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                             spb_cfg: Optional[SPBConfig] = None, *,
                             num_stages: int, depth: Optional[int] = None,
                             schedule: str = "1f1b", group=None,
                             tensor_parallel: int = 1,
                             sequence_parallel: bool = False,
                             zero2: bool = False,
                             remat: Optional[str] = None,
                             shards=None) -> Callable:
    """A (state, batch) -> (state, metrics) step of this rank's stage of
    the pipeline ``group`` (a ``dist/group.PipeGroup``; None: one rank,
    ``num_stages`` 1), interpreting a ``dist/pipeline/schedules`` table
    (``"1f1b"`` or ``"gpipe"`` over ``tcfg.microbatches``) with
    ``dist/pipeline/runtime.run_schedule``.

    ``depth`` is the SPB suffix depth, mapped to a stage truncation point
    (``config.depth_to_bwd_stages``): the stages below it get no backward
    items, so they compute no weight gradients, send no cotangents and
    keep no cotangent stash, and launch no backward kernel.  ``state`` is
    the rank's share (``stage.local_tree``): stage 0 embeds the tokens
    (live only when every stage is), the last stage runs the head.  With
    tied embeddings the head's gradient of the table goes back to stage 0
    and is summed there with the embedding's own; after the update stage
    0 sends the table to the last stage, which keeps it as
    ``state["head"]["tok"]`` (each model index sends its own).  The
    gradient norm counts each element once over the whole grid
    (:func:`_pipeline_norm`); ``_apply``'s optimizer then runs on the
    stage's leaves with the SPB scales of its rows, on this rank's ZeRO-1
    slices with ``shards`` (all-gathered over the stage's data group
    after).  ``batch`` holds this data index's rows
    (``PipeGroup.shard(batch, microbatches)``).

    ``tensor_parallel`` above 1 column/row-shards the stage weights over
    the group's model axis (its size must agree), with the joins'
    collectives inside the stage; ``sequence_parallel`` also shards the
    in-stage residual stream over it on the sequence dim.  ``zero2``
    reduce-scatters each stage gradient over the data axis on the dim its
    ZeRO-1 moments shard (``shards``), so the optimizer's update runs on
    the slice alone.  With ``tcfg.compression`` each rank gathers the
    whole gradient tree of its data index (over the stage and model axes;
    under ``zero2`` its slices over the data axis first), compresses it
    with the one-process draw (:func:`compression_generator`) and keeps
    its part (:func:`_compressed_share`); the norm then counts the
    compressed part, as the reference clips the compressed tree.

    ``spb_cfg`` is stamped with ``pipeline_stages``, as the engine does,
    so the per-block scales count the stage-snapped depths."""
    from repro_torch.config import depth_to_bwd_stages
    from repro_torch.dist.group import PipeGroup
    from repro_torch.dist.pipeline import runtime, schedules
    from repro_torch.dist.pipeline import stage as stage_lib

    stage_lib.check_pipeline_compatible(cfg, num_stages)
    tp = check_pipeline_knobs(cfg, tensor_parallel, sequence_parallel)
    group = group or PipeGroup()
    if group.num_stages != num_stages:
        raise ValueError(f"num_stages={num_stages} but the pipeline group "
                         f"has {group.num_stages} stages")
    msize = group.model.size
    if tp > 1 and msize != tp:
        raise ValueError(f"tensor_parallel={tp} but the mesh's model axis "
                         f"has size {msize}")
    zero2 = zero2 and group.data.size > 1     # a no-op without a data axis
    if zero2 and shards is None:
        raise ValueError("zero2 shards the gradients as ZeRO-1 shards the "
                         "moments: it needs the ZeRO-1 slices (zero1=True)")
    if spb_cfg is not None and spb_cfg.pipeline_stages != num_stages:
        spb_cfg = dataclasses.replace(spb_cfg, pipeline_stages=num_stages)
    remat = lm.resolve_remat(remat)
    m = max(1, tcfg.microbatches)
    bwd_stages = depth_to_bwd_stages(cfg, depth, num_stages)
    table = schedules.build(schedule, num_stages, m, bwd_stages=bwd_stages)
    smap = stage_lib.build_stage_map(cfg, num_stages)
    tp_group = group.model if tp > 1 else None
    fns = stage_lib.make_stage_fns(cfg, smap, tp_group=tp_group,
                                   sequence_parallel=sequence_parallel,
                                   remat=remat)
    aux_weight = 0.01 if cfg.moe is not None else 0.0   # lm.loss_fn's
    head_loss = stage_lib.make_head_loss(cfg)
    embed_live = bwd_stages == num_stages
    s = group.stage
    first, last = s == 0, s == num_stages - 1
    tied = cfg.tie_embeddings
    rows = smap.rows(s)
    dtype = lm._dtype(cfg)
    # per group leaf: sharded over the model axis; its ZeRO-2 dim
    model_sharded = None if tp_group is None else [
        tree_map_with_path(lambda path, t: stage_lib.model_shard_dim(
            path, t.shape) is not None, gp)
        for gp in lm.param_shapes(cfg)["groups"]]
    zero2_parts = shards["groups"] if zero2 else None
    zero2_dims = None if not zero2 else [
        tree_map(lambda part: None if part is None else part[0], gp,
                 is_leaf=sharding.is_slice) for gp in zero2_parts]

    def step(state: State, batch, *, sched=None, update: bool = True
             ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        b = tokens.shape[0]
        if b % m:
            raise ValueError(f"batch size {b} not divisible by {m} "
                             f"microbatches")
        if sequence_parallel and tokens.shape[1] % tp:
            raise ValueError(f"sequence length {tokens.shape[1]} not "
                             f"divisible by tensor_parallel={tp}")
        mb = b // m
        xs = x = None
        if first:
            with torch.set_grad_enabled(embed_live):
                x = stage_lib.embed_tokens(params["embed"], tokens, cfg)
            xs = x.reshape((m, mb) + tuple(x.shape[1:]))
        head = ys = None
        if last:
            ys = labels.reshape((m, mb) + tuple(labels.shape[1:]))
            embed = params["embed"] if first or not tied else state["head"]
            head = {"final_norm": params["final_norm"],
                    "embed": {k: embed[k] for k in
                              (("tok",) if tied else ("unembed",))}}
        weights = stage_lib.stage_weights(params["groups"], smap)
        res = runtime.run_schedule(
            table, fns, weights, xs, group=group, loss_fn=head_loss, ys=ys,
            head_params=head, capture_input_grads=embed_live, stage_aux=True,
            aux_weight=aux_weight,
            act_shape=((mb, tokens.shape[1], cfg.d_model), dtype),
            sequence_parallel=sequence_parallel,
            model_sharded=None if model_sharded is None else
            stage_lib.stage_weights(model_sharded, smap),
            zero2_dims=None if zero2_dims is None else
            stage_lib.stage_weights(zero2_dims, smap))
        dw = res["stage_grads"]
        grads = {"groups": [dw] if smap.trivial else
                 [dw[f"g{g}"] for g in range(len(smap.caps))]}
        if first:
            d_tok = None
            if embed_live:
                (d_tok,) = torch.autograd.grad(
                    x, params["embed"]["tok"],
                    res["input_grads"].reshape(x.shape))
                # each data rank's rows: the table's gradient is their sum
                group.data.all_reduce(d_tok)
            if tied and last:
                d_tok = _sum(d_tok, res["head_grads"]["embed"]["tok"])
            elif tied:
                d_tok = _sum(d_tok, group.recv(params["embed"]["tok"].shape,
                                               dtype, num_stages - 1))
            grads["embed"] = {"tok": d_tok}
        if last:
            hg = res["head_grads"]
            grads["final_norm"] = hg["final_norm"]
            if not tied:
                grads.setdefault("embed", {})["unembed"] = \
                    hg["embed"]["unembed"]
            elif not first:
                group.send(hg["embed"]["tok"], 0)
        metrics = {"loss": res["loss"] + aux_weight * res["aux"],
                   "xent": res["loss"], "moe_aux": res["aux"]}
        if not update:
            return state, metrics
        if tcfg.compression != "none":
            grads = _compressed_share(grads, cfg, tcfg, smap, group, tp,
                                      state["step"], zero2_parts)
        gnorm = _pipeline_norm(grads, group, res["loss"].device,
                               model_sharded, zero2_dims)
        _, _, opt_metrics = optimizers.apply_updates(
            params, grads, state["opt"], state["step"], tcfg, cfg=cfg,
            spb_cfg=spb_cfg, sched=sched, shards=shards, gnorm=gnorm,
            rows=rows)
        if shards is not None:
            with torch.no_grad():
                for p, part in zip(tree_leaves(params),
                                   tree_leaves(shards,
                                               is_leaf=sharding.is_slice)):
                    if part is not None:
                        group.data.all_gather(p.detach(), part[0])
        if tied and num_stages > 1:
            with torch.no_grad():
                if first:
                    group.send(params["embed"]["tok"], num_stages - 1)
                elif last:
                    state["head"]["tok"].copy_(group.recv(
                        state["head"]["tok"].shape, dtype, 0))
        state["step"] += 1
        return state, {**metrics, **opt_metrics}

    step.bwd_stages = bwd_stages
    step.table = table
    return step


def _sum(a, b):
    return b if a is None else a + b


def _pipeline_norm(grads, group, device, model_sharded=None,
                   zero2_dims=None) -> torch.Tensor:
    """The gradient norm over the whole grid, each element counted once.
    This rank's sums of squares are kept apart by how a leaf lies: one the
    model axis shards (``model_sharded``) or that ZeRO-2 narrowed over the
    data axis (``zero2_dims``) is summed over that axis, and one held whole
    there counts once (the data ranks hold the same averaged gradients,
    the model ranks the same norms, table and head).  The stages' totals
    are then summed over the stage axis."""
    n = len(tree_leaves(grads["groups"]))
    on_model = tree_leaves(model_sharded) if model_sharded else [False] * n
    on_data = [d is not None for d in tree_leaves(zero2_dims)] \
        if zero2_dims else [False] * n
    kinds = list(zip(on_model, on_data)) + [(False, False)] * (
        len(tree_leaves(grads)) - n)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    sq = {(m, d): zero for m in (False, True) for d in (False, True)}
    for g, kind in zip(tree_leaves(grads), kinds):     # the groups first
        if g is not None:
            sq[kind] = sq[kind] + g.float().square().sum()
    if zero2_dims:
        both = group.data.all_reduce(torch.stack([sq[(True, True)],
                                                  sq[(False, True)]]))
        sq[(True, True)], sq[(False, True)] = both[0], both[1]
    sharded = sq[(True, True)] + sq[(True, False)]
    if model_sharded:
        sharded = group.model.all_reduce(sharded.reshape(1))[0]
    total = sharded + sq[(False, True)] + sq[(False, False)]
    return torch.sqrt(group.pipe_all_reduce(total.reshape(1))[0])


# called once a compressed step of a grid or a pipeline with
# (gather_s, compress_s, gathered_bytes, world_bytes): the host seconds of
# the gathers that rebuild the whole tree and of the compressors (the
# device synchronized around each while a sink listens), the bytes this
# rank received in the gathers, and those a gather of the same parts from
# every rank of the world would have delivered
COMPRESSION_SINKS: List[Callable[[float, float, int, int], None]] = []


def _sync(device) -> None:
    if COMPRESSION_SINKS and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t is not None)


def _compress_timed(whole, tcfg: TrainConfig, step: int, device,
                    gather_s: float, gathered: int, world: int):
    """``compress.compress_tree`` of ``whole`` with the one-process draw
    at ``step``; reports the step's costs to :data:`COMPRESSION_SINKS`."""
    _sync(device)
    t0 = time.perf_counter()
    out = _compressed(whole, tcfg, step)
    _sync(device)
    for sink in COMPRESSION_SINKS:
        sink(gather_s, time.perf_counter() - t0, gathered, world)
    return out


def _gather_objects(obj, pg, n: int) -> list:
    """Every rank's ``obj`` of the process group ``pg`` (``n`` ranks; at
    one rank no group), in group order, through the host."""
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    return out


def _unsliced(g, part, data):
    """The whole of a ZeRO-2 slice ``g`` (``part``: this rank's ``(dim,
    start, length)``) over the data group; ``g`` itself when unsliced."""
    if g is None or part is None:
        return g
    dim, start, length = part
    shape = list(g.shape)
    shape[dim] = length * data.size
    whole = g.new_empty(shape)
    whole.narrow(dim, start, length).copy_(g)
    return data.all_gather(whole, dim)


def _compressed_share(grads, cfg: ModelConfig, tcfg: TrainConfig, smap,
                      group, tp: int, step: int, zero2_parts=None):
    """This rank's part of the whole gradient tree compressed as one
    process compresses it.  Under ZeRO-2 (``zero2_parts``: this rank's
    slice of each stage leaf, as ``shards["groups"]``) each slice is
    first all-gathered over the data group.  The parts then go, on the
    host, to the ranks of this data index alone: each ``(stage, model
    rank)``'s over the model group, then those rows over the stage axis.
    Each rank assembles its data index's whole tree (``stage.assemble``: a
    frozen stage's rows of a leaf are zeros, and a leaf no stage holds
    live stays ``None``), compresses it on its device with
    :func:`compression_generator`'s draw at ``step`` and keeps its part
    (``stage.local_tree``, narrowed to its ZeRO-2 slice; ``None`` where
    its gradient was).  The costs go to :data:`COMPRESSION_SINKS`."""
    from repro_torch.dist.pipeline import stage as stage_lib

    T = max(tp, 1)
    device = next(g.device for g in tree_leaves(grads) if g is not None)
    _sync(device)
    t0 = time.perf_counter()
    received = 0
    whole_grads = grads
    if zero2_parts is not None:
        whole_grads = {**grads, "groups": tree_map(
            lambda g, part: _unsliced(g, part, group.data),
            grads["groups"], zero2_parts)}
        sliced = [t for t, part in zip(
            tree_leaves(whole_grads["groups"]),
            tree_leaves(zero2_parts, is_leaf=sharding.is_slice))
            if part is not None]
        n = group.data.size
        received = _tree_bytes(sliced) * (n - 1) // n
    mine = tree_map(lambda g: None if g is None else g.detach().cpu(),
                    whole_grads)
    row = _gather_objects((group.stage, group.model_index, mine),
                          group.model.pg, group.model.size)
    rows = _gather_objects(row, group.pipe_pg, group.num_stages)
    ours = {(s, t): tree for r in rows for s, t, tree in r}
    sizes = {k: _tree_bytes(tree) for k, tree in ours.items()}
    own = sizes[(group.stage, group.model_index)]
    received += sum(sizes.values()) - own
    world = group.data.size * sum(sizes.values()) - own
    shapes = lm.param_shapes(cfg)
    S = smap.num_stages
    held = [tree_map(lambda m, g: torch.zeros(m.shape, dtype=m.dtype)
                     if g is None else g,
                     stage_lib.local_tree(shapes, cfg, smap, s, model=(t, T)),
                     ours[(s, t)])
            for s in range(S) for t in range(T)]
    whole = stage_lib.assemble(held, cfg, smap, T)
    # live: a group leaf some stage holding its rows backpropagated, a
    # head leaf its owner has a gradient of
    live = {"groups": [tree_map(
        lambda *gs: any(g is not None for g in gs),
        *(ours[(s, 0)]["groups"][i] for s in range(S) if smap.rows(s)[i][1]))
        for i in range(len(smap.caps))]}
    for s in range(S):
        got = ours[(s, 0)]
        for key, sub in stage_lib.owned_head(cfg, S, s).items():
            if sub:
                live.setdefault(key, {}).update(
                    {k: got[key][k] is not None for k in sub})
            else:
                live[key] = got[key] is not None
    whole = tree_map(lambda g, on: g.to(device) if on else None, whole,
                     {k: live[k] for k in whole})
    del held, ours, rows, row, mine
    _sync(device)
    out = _compress_timed(whole, tcfg, step, device,
                          time.perf_counter() - t0, received, world)
    del whole
    filled = tree_map(lambda g, m: torch.zeros(m.shape, dtype=m.dtype,
                                               device=device)
                      if g is None else g, out, {k: shapes[k] for k in out})
    share = stage_lib.local_tree(filled, cfg, smap, group.stage,
                                 model=(group.model_index, T))
    if zero2_parts is not None:
        share["groups"] = tree_map(
            lambda c, part: optimizers.local(c, part).contiguous(),
            share["groups"], zero2_parts)
    return tree_map(lambda g, c: None if g is None else c.to(g.device),
                    grads, share)


def build_pipeline_train_steps(cfg: ModelConfig, tcfg: TrainConfig,
                               spb_cfg: SPBConfig, *, num_stages: int,
                               schedule: str = "1f1b", group=None,
                               tensor_parallel: int = 1,
                               sequence_parallel: bool = False,
                               zero2: bool = False,
                               remat: Optional[str] = None,
                               shards=None) -> Dict[Any, Callable]:
    """The per-depth pipeline step table: ``None`` (full backprop) plus,
    for temporal SPB, one entry per distinct stage-snapped cycle depth.
    ``spatial`` and ``temporal-mb`` raise, as in the reference."""
    if spb_cfg.mode in ("spatial", "temporal-mb"):
        raise ValueError(f"SPB mode {spb_cfg.mode!r} is not supported "
                         f"under pipeline parallelism (use 'temporal' "
                         f"or 'off')")
    if spb_cfg.pipeline_stages != num_stages:
        spb_cfg = dataclasses.replace(spb_cfg, pipeline_stages=num_stages)
    kw = dict(num_stages=num_stages, schedule=schedule, group=group,
              tensor_parallel=tensor_parallel,
              sequence_parallel=sequence_parallel, zero2=zero2,
              remat=remat, shards=shards)
    steps: Dict[Any, Callable] = {
        None: make_pipeline_train_step(cfg, tcfg, spb_cfg, **kw)}
    if spb_cfg.mode == "temporal":
        for d in sorted(set(spb_lib.snapped_depths(cfg, spb_cfg))):
            steps[d] = make_pipeline_train_step(cfg, tcfg, spb_cfg,
                                                depth=d, **kw)
    return steps


# ---------------------------------------------------------------------------
# The sharded decode step (the serving grid)
# ---------------------------------------------------------------------------

def shard_decode_step(mesh: sharding.Mesh, cfg: ModelConfig,
                      global_batch: int, max_len: int, *, enc_len: int = 0,
                      rules_overrides: Optional[Dict[str, Any]] = None,
                      group=None):
    """One-token decode on one rank of the serving grid ``mesh``, axes
    ``("data", "model")`` or ``("pod", "data", "model")`` (the counterpart
    of ``repro/dist/steps.shard_decode_step``).

    Returns ``(fn, params_shapes, cache_shapes, specs)``: the whole
    model's parameter and dense-cache shapes (meta tensors), the specs
    that lay them out under ``rules_overrides`` (``specs["params"]``:
    ``dist/sharding.serve_params_pspec``; ``"cache"``:
    ``grid_cache_pspec``, the batch over ``("pod", "data")``, the sequence
    over ``kv_seq``'s axes and an attn/local layer's KV heads over
    ``model``; ``"tokens"``, ``"logits"``), and ``fn(params, cache,
    tokens) -> (logits, cache)``, this rank's decode step on its blocks
    (``sharding.grid_share`` of the whole trees at the rank's
    ``sharding.mesh_coords``, ``sharding.local_shapes`` of the cache), the
    cache updated in place (the port's counterpart of the reference's
    donation).  The logits are this rank's rows, the vocab whole.

    ``group``: this rank's ``dist/group.GridGroup``, whose data group
    holds the mesh's pod x data ranks and whose model group its model
    ranks (needed when either the model axis or the ``kv_seq`` axes have
    several ranks): the row-parallel joins all-reduce over its model
    group, and under a ``kv_seq`` override the partial attentions are
    joined over the ranks of its axes (``GridGroup.seq_group``,
    ``models/layers.seq_combine``).  The small-batch override of the
    reference's dry run, ``{"batch": None, "kv_seq": ("data", "model")}``,
    holds the batch on every rank and shards the sequence over the whole
    grid; ``kv_seq`` takes ``model`` first there, so an attn/local layer
    runs whole on every rank (``sharding.grid_whole``).  An override the
    port has no path for raises (``sharding.check_overrides``), as does a
    layout that does not divide (the reference's refusal)."""
    from repro_torch.serve import kvcache
    sharding.check_overrides(rules_overrides)
    extra = set(mesh.axis_names) - set(sharding.GRID_AXES)
    if extra:
        raise ValueError(f"shard_decode_step on {mesh}: a serving grid's "
                         f"axes are {sharding.GRID_AXES}, not {sorted(extra)}")
    D = math.prod(mesh.shape.get(a, 1) for a in sharding.DP_AXES)
    T = mesh.shape.get("model", 1)
    with sharding.rules(rules_overrides):
        whole = sharding.grid_whole(mesh)
        axes = sharding.seq_axes(mesh)
        rows = sharding.batch_ranks(mesh)
        params_shapes = lm.param_shapes(cfg)
        cache_shapes = lm.cache_shapes(cfg, global_batch, max_len,
                                       enc_len=enc_len)
        specs = {"params": sharding.serve_params_pspec(params_shapes, cfg,
                                                       mesh),
                 "cache": sharding.grid_cache_pspec(cache_shapes, cfg,
                                                    mesh),
                 "tokens": sharding.spec_for(("batch", None), mesh=mesh),
                 "logits": sharding.spec_for(("batch", None, None),
                                             mesh=mesh)}
    if global_batch % rows:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{rows} data ranks")
    kvcache.check_model_parallel(cfg, T, whole)
    sharding.check_divides(specs["cache"], cache_shapes, mesh, "cache")
    n_seq = math.prod(mesh.shape[a] for a in axes)
    if group is not None:
        if (group.data.size, group.model.size) != (D, T):
            raise ValueError(f"shard_decode_step on {mesh} by a rank of "
                             f"{sharding.mesh_for(group)}")
    elif T > 1 or n_seq > 1:
        raise ValueError(f"shard_decode_step on {mesh}: {T} model ranks "
                         f"and {n_seq} sequence shards need this rank's "
                         f"group=")
    tp = group.model if group is not None and T > 1 else None
    seq = group.seq_group(mesh, axes) if n_seq > 1 else None

    def fn(params, cache, tokens):
        return lm.decode_step(params, cache, tokens, cfg, tp=tp, seq=seq,
                              whole=whole)

    return fn, params_shapes, cache_shapes, specs
