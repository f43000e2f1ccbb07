"""SPBEngine on one device: train state + depth policy + per-depth step
table (the single-device surface of ``repro/engine/engine.py``).

PyTorch runs eagerly, so a step-table entry is a plain function of
``dist/steps.py`` and the session keeps the state on its device, updated
in place.  With ``shared_cache`` (the default) the functions come from the
process-wide :data:`repro_torch.engine.stepcache.GLOBAL`, so co-located
engines of one config share them.

``compile_table`` is the counterpart of the reference's AOT compile.  On a
CUDA device it captures one CUDA graph per depth key (``engine/graphs.py``)
into the engine's one memory pool; a graph binds the session's state
buffers, so later states are copied into them (``init_state``,
``attach_state``).  On the CPU the table holds the eager step functions,
the plain version, so its semantics are testable there.  ``export_aot`` /
``load_aot`` store and restore the table (``engine/aot.py``); a loaded
table is frozen: a depth it lacks resolves to the nearest deeper entry.

The layer-recompute policy (``remat=``: 'none', 'dots', 'full'; None
takes ``lm.REMAT``'s value) is resolved when the engine is built and
closed over by every step; it is part of the step-cache key and of a
stored table's key, so a table captured under one policy is a miss under
another.

``submesh=`` (a ``launch/mesh.Submesh``) places the session on a share of
its device: on a card every call that launches work (``init_state``,
``attach_state``, ``train_step``, ``compile_table``, ``load_aot``) runs on
the share's stream, so on its SMs alone, and returns once that stream has
run it (a wait on the share, not the card: another submesh's job runs on
meanwhile).  The step-cache key and a stored table's path carry the
submesh's fingerprint.  :meth:`SPBEngine.resize` moves the session to
another submesh (on one card no bytes move).  With ``group=`` or under a
pipeline it raises.

``group=`` (a ``dist/group.DataGroup``) makes the engine one rank of a
data group: its device is the group's, each ``train_step`` takes this
rank's rows of the global batch, and the steps average the gradients
over the group (``dist/steps.py``; spatial SPB weights them per layer).
A depth policy that reads the clock could pick different depths on
different ranks, whose collectives would then not match, so rank 0's
depth is broadcast every step.  The step-cache key carries the group's
size (and, for spatial, the rank's level).  A gloo collective runs on the
host, which no CUDA graph can capture, so ``compile_table`` and
``load_aot`` raise under a group of several ranks.

``zero1=True`` (the default, as the reference's) lays the state out as
the reference's ``SPBEngine`` does: ``state_specs`` is
``dist/sharding.state_pspec(state_shapes, mesh_for(group), zero1=)``, so
over a data group of n ranks every optimizer leaf (the moments and the f32
masters) is sharded on the dim ``dp_partition_plan`` picks, and each rank
holds its slice (``shards``, from ``sharding.shard_slices``); the
parameters stay whole on every rank.  ``init_state`` builds the slices
directly, ``attach_state`` keeps this rank's slice of a whole state, and
:meth:`gathered_state` gathers the whole state to rank 0 (a checkpoint's
view).  At group size 1 there is no plan: the state and the steps are
those of one device.  The step-cache key carries ``zero1``.

``parallelism="pipeline"`` (with ``group=`` a ``dist/group.PipeGroup``,
one stage a rank; none: a pipeline of one stage) makes the engine one
stage of a pipeline, as the reference's ``parallelism="pipeline"`` does
over its ``(stage, data)`` mesh: ``spb.pipeline_stages`` is stamped, so
the policy's depths snap to stage boundaries, the step table comes from
``dist/steps.build_pipeline_train_steps`` (``pipeline_schedule``: "1f1b"
or "gpipe"), and ``temporal-mb`` and ``spatial`` raise.  The rank holds
its stage's share of the state (``dist/pipeline/stage.local_tree``);
``init_state`` draws the whole tree and keeps that share, and
``attach_state`` takes it from a whole state.  Over a data axis of more
than one rank the optimizer state is ZeRO-1-sharded over ``data`` by
``dist/sharding.pipeline_state_pspec``; :meth:`gathered_state` gives rank
0 the whole state in the one-process format.  ``tensor_parallel``
(default: the group's model-axis size, as the reference's default is its
mesh's) above 1 column/row-shards the stages' weights over the grid's
``model`` axis, and each rank then holds its model shard of them
(``stage.local_tree(model=)``) and the norms, the table and the head
whole; ``sequence_parallel`` shards the in-stage residual stream over
that axis, and ``zero2`` reduce-scatters the stage gradients over
``data`` into the ZeRO-1 moments' layout (``dist/steps.
make_pipeline_train_step``).  :meth:`gathered_state` gathers the model
shards too.  ``compile_table`` and ``load_aot`` raise: a pipeline's
messages go through the host.  Outside a pipeline the three knobs raise
with the reference's text.

``group=`` a ``dist/group.GridGroup`` makes the engine one rank of a
``(data, model)`` grid, the counterpart of the reference's
``SPBEngine(mesh=<(data, model) mesh>)`` SPMD step: its MoE layers run
``impl="ep"`` with their experts sharded over ``model``
(``models/moe.moe_fwd_ep``), everything else replicated over ``model``
(``dist/sharding.grid_state_pspec``: the ``"expert"`` rule alone; GSPMD
would also shard heads and vocab there), and the steps sum the router's
and the shared expert's gradients over ``model`` before they average
over ``data`` (``dist/steps.py``).  The rank holds its experts
(``experts``, from ``sharding.axis_slices``) and, under ZeRO-1, its data
slices of every optimizer leaf; ``init_state`` draws the whole tree and
keeps that share, ``attach_state`` takes it from a whole state (or a
share of the same layout), and :meth:`gathered_state` gives rank 0 the
whole state in the one-process format, so a checkpoint restores into one
process or into a grid of another T.  Rank 0's depth is broadcast over
the whole grid every step.  Compression gathers the experts over
``model`` and compresses the whole tree with one process's draw
(``dist/steps.py``).  ``spatial`` raises on a grid with T > 1 (the
reference's step does not lower there), as do ``compile_table`` and
``load_aot``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.config import (ModelConfig, SPBConfig, TrainConfig,
                                snap_depth, snap_depth_to_stages)
from repro_torch.core import spb as spb_lib
from repro_torch.device import device_fingerprint, on_share, resolve_device
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.engine import aot, graphs, stepcache
from repro_torch.engine.policies import DepthPolicy, make_policy
from repro_torch.dist.group import DataGroup, GridGroup, PipeGroup
from repro_torch.dist.pipeline import stage as pp_stage
from repro_torch.launch.mesh import make_pipeline_mesh
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map

State = Dict[str, Any]


def _placed(method: Callable) -> Callable:
    """Run an engine method on the engine's submesh (its card share's
    stream; nothing on the CPU) and return once the share has run it, so
    what it made can be read from any stream."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        share = self.submesh.share if self.submesh is not None else None
        with on_share(share):
            out = method(self, *args, **kw)
        if share is not None:
            share.stream.synchronize()
        return out
    return run


class TensorSpec(NamedTuple):
    """The shape and dtype of one batch leaf (the counterpart of jax's
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def specs_from_signature(sig) -> Dict[str, TensorSpec]:
    """Batch specs back from a stored ``inputs`` signature."""
    return {path: TensorSpec(tuple(shape), getattr(torch, dtype))
            for path, shape, dtype in sig}


class _GraphedTrainStep:
    """One depth key's CUDA graph, bound to the session's state: a
    (state, batch) -> (state, metrics) step like the eager one.  The batch
    and the schedule (``optimizers.schedule_values``) are static inputs,
    refilled before each replay; the metrics are cloned out of the graph.
    """

    def __init__(self, engine: "SPBEngine", key: Any, specs):
        dev = engine.device
        self.tcfg = engine.tcfg
        self.state = state = engine.state
        self.batch = {k: torch.zeros(tuple(s.shape), dtype=s.dtype,
                                     device=dev) for k, s in specs.items()}
        self.sched = torch.zeros(3, dtype=torch.float32, device=dev)
        fn = engine._eager_step(key)
        if engine.spb.mode != "off" and engine.spb.lr_rescale:
            # the SPB scales reach the card before the capture
            spb_lib.placed_scales(engine.cfg, engine.spb, dev,
                                  torch.float32)
        step0 = state["step"]

        def view():
            return {"params": state["params"], "opt": state["opt"],
                    "step": step0}

        def warmup():           # the gradients alone: the state stays
            fn(view(), self.batch, update=False)

        self.graph = graphs.capture(
            lambda: fn(view(), self.batch, sched=self.sched)[1],
            device=dev, pool=engine._graph_pool(), warmup=warmup,
            stream=engine.submesh.share.stream if engine.submesh is not None
            else None)

    def __call__(self, state: State, batch) -> tuple:
        if state is not self.state:
            raise RuntimeError("a graphed step runs on the state it was "
                               "captured on; adopt a new state with "
                               "init_state() or attach_state()")
        if set(batch) != set(self.batch):
            raise ValueError(f"batch keys {sorted(batch)} != the table's "
                             f"{sorted(self.batch)}")
        for k, buf in self.batch.items():
            if tuple(batch[k].shape) != tuple(buf.shape):
                raise ValueError(f"batch[{k!r}] has shape "
                                 f"{tuple(batch[k].shape)}; the table was "
                                 f"captured at {tuple(buf.shape)}")
            buf.copy_(batch[k])
        host = torch.from_numpy(optimizers.schedule_values(
            self.tcfg, state["step"]))
        self.sched.copy_(host.pin_memory() if self.sched.is_cuda else host,
                         non_blocking=True)
        metrics = self.graph.replay()
        state["step"] += 1
        return state, {k: v.clone() for k, v in metrics.items()}


class SPBEngine:
    """A training session on one device (``cuda`` unless ``device`` says
    otherwise)::

        engine = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal"))
        engine.init_state(0)
        for step in range(tcfg.num_steps):
            metrics = engine.train_step(pipe.get_batch(step), step)
    """

    _POLICY = object()          # sentinel: "ask the depth policy"

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 spb_cfg: Optional[SPBConfig] = None, *,
                 policy: Optional[DepthPolicy] = None, device=None,
                 shared_cache: bool = True, remat: Optional[str] = None,
                 group=None, zero1: bool = True,
                 parallelism: str = "spmd",
                 pipeline_schedule: str = "1f1b",
                 tensor_parallel: Optional[int] = None,
                 sequence_parallel: bool = False, zero2: bool = False,
                 submesh=None):
        if parallelism not in ("spmd", "pipeline"):
            raise ValueError(f"unknown parallelism {parallelism!r}; "
                             f"known: spmd, pipeline")
        if submesh is not None:
            if group is not None or parallelism == "pipeline":
                raise ValueError("submesh= places a session of one process "
                                 "on a share of one device; a group's or a "
                                 "pipeline's ranks are processes")
            if device is not None and device_fingerprint(device) != \
                    device_fingerprint(submesh.device):
                raise ValueError(f"device={device!r} disagrees with the "
                                 f"submesh's {submesh.device}")
            device = submesh.device
        self.submesh = submesh
        self.resizes = 0
        self.cfg = cfg
        self.tcfg = tcfg
        self.spb = spb_cfg or SPBConfig()
        self.remat = lm.resolve_remat(remat)
        self.parallelism = parallelism
        self.pipeline_schedule = pipeline_schedule
        pipeline = parallelism == "pipeline"
        if group is None:
            self.device = resolve_device(device)
            group = PipeGroup(device=self.device, data=DataGroup(
                device=self.device)) if pipeline else \
                DataGroup(device=self.device)
        elif device is not None and \
                resolve_device(device).type != group.device.type:
            raise ValueError(f"device={device!r} disagrees with the "
                             f"group's {group.device}")
        else:
            self.device = group.device
        if pipeline != isinstance(group, PipeGroup):
            kinds = "PipeGroup" if pipeline else "DataGroup or GridGroup"
            raise ValueError(f"parallelism={parallelism!r} takes a {kinds}")
        self.group = group
        grid = isinstance(group, GridGroup)
        # the data group the steps average over; the grid's model group
        self._data = group.data if grid else group
        self._model = group.model if grid else None
        self.experts = None
        self.zero1 = zero1
        self.state_shapes = steps_lib.train_state_shapes(cfg, tcfg)
        if pipeline:
            self._init_pipeline(tensor_parallel, sequence_parallel, zero2)
        else:
            steps_lib.refuse_pipeline_knobs(tensor_parallel,
                                            sequence_parallel, zero2)
            self.tensor_parallel, self.sequence_parallel = 0, False
            self.zero2 = False
            self.pipeline_stages = 0
            self._stage_map = None
            self.mesh = sharding.mesh_for(group)
            if grid:
                self._init_grid()
            else:
                self.state_specs = sharding.state_pspec(
                    self.state_shapes, self.mesh, zero1=zero1)
                self.shards = sharding.opt_slices(
                    self.state_shapes, self.state_specs, self.mesh,
                    group.rank)
        self.policy = policy or make_policy("cycle", cfg, self.spb)
        self.shared_cache = shared_cache
        self._steps: Dict[Any, Callable] = {}
        self._compiled: Dict[Any, Callable] = {}
        self._graphs: Dict[Any, _GraphedTrainStep] = {}
        self._pool = None
        self._frozen = False
        self._warned_depths: set = set()
        for k in steps_lib.spb_step_keys(cfg, self.spb):
            self.step_fn(k)
        self.state: Optional[State] = None
        self.last_depth: Any = None
        self._auto_step = 0

    def _init_grid(self) -> None:
        """A ``(data, model)`` grid rank's layout: the specs (experts over
        ``model``, ZeRO-1 over ``data``), this rank's experts and its
        ZeRO-1 slices of the optimizer leaves it holds."""
        group, mesh = self.group, self.mesh
        steps_lib.refuse_on_grid(self.spb, group.model)
        self.state_specs = sharding.grid_state_pspec(
            self.state_shapes, mesh, zero1=self.zero1)
        self.experts = sharding.axis_slices(
            self.state_specs["params"], self.state_shapes["params"], mesh,
            "model", group.model_index)
        key = sorted(self.state_shapes["opt"])[0]
        shards = sharding.pipeline_opt_slices(
            self.state_specs["opt"][key],
            self._expert_rows(self.state_shapes["opt"][key]), mesh,
            group.data_index) if self.zero1 else None
        held = tree_map(lambda part: part is not None, shards,
                        is_leaf=sharding.is_slice) if shards else None
        self.shards = shards if held and any(tree_leaves(held)) else None

    def _expert_rows(self, tree, copy: bool = False):
        """This grid rank's experts of a params-shaped tree (a leaf that
        already has the share's shape is taken as it is); the rest whole.
        ``copy``: the share as a tensor of its own."""
        if self.experts is None:
            return tree

        def rows(t, part):
            if part is None or t.shape[part[0]] == part[2]:
                return t
            t = t.narrow(*part)
            return t.clone(memory_format=torch.contiguous_format) \
                if copy else t

        return tree_map(rows, tree, self.experts)

    def _init_pipeline(self, tensor_parallel, sequence_parallel,
                       zero2) -> None:
        """A pipeline rank's layout: the stage map, ``spb.pipeline_stages``
        stamped (depths snap to stage boundaries), the tensor-parallel
        knobs checked as the reference's engine checks them, the grid's
        specs (``pipeline_state_pspec``, ZeRO-1 over ``data``) and this
        rank's slices of its stage's optimizer leaves (of its model
        shards)."""
        cfg, group = self.cfg, self.group
        msize = group.model.size
        tp = msize if tensor_parallel is None else int(tensor_parallel)
        if tp > 1 and tp != msize:
            raise ValueError(
                f"tensor_parallel={tp} but mesh ('stage', 'data', 'model')="
                f"{(group.num_stages, group.data.size, msize)} has "
                f"model-axis size {msize}")
        self.tensor_parallel = tp
        self.sequence_parallel = bool(sequence_parallel)
        self.zero2 = bool(zero2)
        n_stages = self.pipeline_stages = group.num_stages
        if self.spb.mode in ("spatial", "temporal-mb"):
            raise ValueError(f"SPB mode {self.spb.mode!r} is not supported "
                             f"under pipeline parallelism (use 'temporal' "
                             f"or 'off')")
        if self.spb.pipeline_stages != n_stages:
            self.spb = dataclasses.replace(self.spb,
                                           pipeline_stages=n_stages)
        pp_stage.check_pipeline_compatible(cfg, n_stages)
        steps_lib.check_pipeline_knobs(cfg, tp, self.sequence_parallel)
        self._stage_map = smap = pp_stage.build_stage_map(cfg, n_stages)
        self.mesh = make_pipeline_mesh(
            n_stages, data_parallel=group.data.size,
            model_parallel=tp if tp > 1 else 1)
        self.state_specs = sharding.pipeline_state_pspec(
            self.state_shapes, self.mesh, zero1=self.zero1,
            uniform_groups=smap.uniform)
        key = sorted(self.state_shapes["opt"])[0]
        specs = pp_stage.local_tree(     # the stage's leaves' specs
            self.state_specs["opt"][key], cfg, smap, group.stage,
            take=lambda spec, st, cnt: spec,
            is_leaf=lambda x: isinstance(x, sharding.P))
        self.shards = sharding.pipeline_opt_slices(
            specs, self._local(self.state_shapes["opt"][key]), self.mesh,
            group.data_index) if self.zero1 else None

    def _local(self, tree, stage: Optional[int] = None,
               model: Optional[int] = None):
        """A ``(stage, model rank)``'s share of a whole params-shaped tree
        (this rank's by default): its stage's rows, its model shards."""
        return pp_stage.local_tree(
            tree, self.cfg, self._stage_map,
            self.group.stage if stage is None else stage,
            model=(self.group.model_index if model is None else model,
                   self._model_parallel))

    @property
    def _model_parallel(self) -> int:
        """How many model shards a stage's weights are cut into."""
        return self.tensor_parallel if self.tensor_parallel > 1 else 1

    def _pipeline_state(self, params, opt=None, step: int = 0) -> State:
        """This rank's state from whole ``params`` (and a whole ``opt``):
        its stage's leaves copied out (so the whole tree can go), its
        ZeRO-1 slices of the optimizer leaves, and on the last stage of a
        tied model the head's copy of the token table."""
        dev = self.device

        def own(t, part=None):
            if part is not None and t.shape[part[0]] != part[2]:
                t = t.narrow(*part)
            return t.detach().to(dev, copy=True,
                                 memory_format=torch.contiguous_format)

        local = tree_map(lambda t: own(t).requires_grad_(True),
                         self._local(params))
        if opt is None:
            state = steps_lib.state_from_params(local, self.tcfg, self.shards)
        else:
            state = {"params": local, "step": int(step), "opt": {
                k: tree_map(own, self._local(sub), self.shards)
                if self.shards else tree_map(own, self._local(sub))
                for k, sub in opt.items()}}
        if self.cfg.tie_embeddings and self.pipeline_stages > 1 and \
                self.group.stage == self.pipeline_stages - 1:
            state["head"] = {"tok": own(params["embed"]["tok"])}
        return state

    # -- state lifecycle ---------------------------------------------------

    @_placed
    def init_state(self, seed: int) -> State:
        """Random params from a generator seeded with ``seed`` on the
        session's device, fresh optimizer state (this rank's slices under
        ZeRO-1)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.pipeline_stages:    # every rank draws the whole, keeps its
            self.state = self._pipeline_state(     # stage's share
                lm.init_lm(gen, self.cfg, self.device))
            return self.state
        if self.experts is not None:    # a grid rank: the whole, its experts
            params = tree_map(
                lambda t: t.requires_grad_(True),
                self._expert_rows(lm.init_lm(gen, self.cfg, self.device),
                                  copy=True))
            return self._adopt(steps_lib.state_from_params(
                params, self.tcfg, self.shards))
        return self._adopt(steps_lib.init_train_state(
            gen, self.cfg, self.tcfg, self.device, self.shards))

    @_placed
    def attach_state(self, state: State) -> State:
        """Adopt an externally built state, moved to the session's device
        (params become leaves that require grad).  Under ZeRO-1 a whole
        optimizer leaf is cut to this rank's slice (a copy); a leaf that
        already has the slice's shape is taken as it is.  A pipeline rank
        takes its stage's share of the whole state."""
        if self.pipeline_stages:
            self.state = self._pipeline_state(state["params"], state["opt"],
                                              state["step"])
            return self.state
        if self._bound() is not None:
            return self._adopt(state)

        def param(t):
            return t.detach().to(self.device).requires_grad_(True)

        def own(t, part):
            if part is None or t.shape[part[0]] == part[2]:
                return t.to(self.device)
            return t.narrow(*part).to(self.device, copy=True,
                                      memory_format=torch.contiguous_format)

        self.state = {
            "params": tree_map(param, self._expert_rows(state["params"],
                                                        copy=True)),
            "opt": {k: tree_map(own, self._expert_rows(sub, copy=True),
                                self.shards)
                    if self.shards
                    else tree_map(lambda t: t.to(self.device),
                                  self._expert_rows(sub, copy=True))
                    for k, sub in state["opt"].items()},
            "step": int(state["step"]),
        }
        return self.state

    @torch.no_grad()
    def gathered_state(self) -> Optional[State]:
        """The whole state on the host, on rank 0; None on the other ranks.
        Collective: every rank of the group calls it.  Each sharded
        optimizer leaf is gathered to rank 0 (``DataGroup.gather``) and
        copied to the host there, one leaf at a time."""
        if self.state is None:
            raise RuntimeError("call init_state()/attach_state() first")
        if self.pipeline_stages:
            return self._gathered_pipeline_state()
        if self.experts is not None:
            return self._gathered_grid_state()
        root = self.group.rank == 0

        def host(t):
            return t.detach().to("cpu", copy=True) if root else None

        def whole(t, part):
            if part is None:
                return host(t)
            full = self.group.gather(t, part[0])
            return full.cpu() if root else None

        opt = {k: tree_map(whole, sub, self.shards) if self.shards
               else tree_map(host, sub)
               for k, sub in self.state["opt"].items()}
        if not root:
            return None
        return {"params": tree_map(host, self.state["params"]), "opt": opt,
                "step": int(self.state["step"])}

    def _gathered_grid_state(self) -> Optional[State]:
        """:meth:`gathered_state` of a grid: each ZeRO-1 slice is gathered
        over the data group to data index 0, whose ranks then all-gather
        their experts over their model group; rank 0 keeps the result."""
        data, model = self.group.data, self.group.model
        root = self.group.rank == 0

        def whole(t, zpart, epart):
            if zpart is not None:
                t = data.gather(t, zpart[0])
            if data.rank != 0:
                return None
            t = t.detach()
            if epart is not None:
                t = model.all_gather(t.contiguous(), epart[0])
            return t.to("cpu", copy=True) if root else None

        none = lambda sub: tree_map(lambda _: None, sub)   # noqa: E731
        params = tree_map(lambda t, e: whole(t, None, e),
                          self.state["params"], self.experts)
        opt = {k: tree_map(whole, sub, self.shards or none(sub),
                           self.experts)
               for k, sub in self.state["opt"].items()}
        if not root:
            return None
        return {"params": params, "opt": opt,
                "step": int(self.state["step"])}

    def _gathered_pipeline_state(self) -> Optional[State]:
        """:meth:`gathered_state` of a pipeline: each ``(stage, model
        rank)``'s data rank 0 gathers its ZeRO-1 slices and sends its share,
        leaf by leaf, to rank 0, which assembles the one-process layout
        (the model shards joined, ``stage.assemble``)."""
        group, data = self.group, self.group.data
        held = {"params": self.state["params"], **self.state["opt"]}

        def whole(t, part):
            if part is None:
                return t.detach().to("cpu", copy=True) if data.rank == 0 \
                    else None
            full = data.gather(t, part[0])
            return full.cpu() if data.rank == 0 else None

        mine = {k: tree_map(whole, v, self.shards)
                if self.shards and k != "params"
                else tree_map(lambda t: whole(t, None), v)
                for k, v in held.items()}
        T = self._model_parallel
        if data.rank != 0 or (group.model_index >= T):
            return None
        if group.rank != 0:
            for t in tree_leaves(mine):
                group.send_to_rank(t, 0)
            return None
        shapes = {"params": self.state_shapes["params"],
                  **self.state_shapes["opt"]}
        parts = []
        for s in range(self.pipeline_stages):
            for m in range(T):
                if (s, m) == (0, 0):
                    parts.append(mine)
                    continue
                src = group.rank_at(s, 0, m)
                parts.append({k: tree_map(
                    lambda x, src=src: group.recv_from_rank(
                        x.shape, x.dtype, src, on_host=True),
                    self._local(v, s, m)) for k, v in shapes.items()})
        out = {k: pp_stage.assemble([p[k] for p in parts], self.cfg,
                                    self._stage_map, T) for k in shapes}
        return {"params": out.pop("params"), "opt": out,
                "step": int(self.state["step"])}

    def _bound(self) -> Optional[State]:
        """The state the captured graphs read and write, if any."""
        return next(iter(self._graphs.values())).state if self._graphs \
            else None

    @torch.no_grad()
    def _adopt(self, state: State) -> State:
        """Make ``state`` the session's.  Once graphs are captured they
        bind the state they were captured on, so its values are copied
        into those buffers instead."""
        bound = self._bound()
        if bound is None:
            self.state = state
            return state
        copy = lambda dst, src: dst.copy_(torch.as_tensor(src))
        tree_map(copy, bound["params"], state["params"])
        tree_map(copy, bound["opt"], state["opt"])
        bound["step"] = int(state["step"])
        self.state = bound
        return bound

    @property
    def step_count(self) -> int:
        return self.state["step"] if self.state is not None else 0

    # -- step table --------------------------------------------------------

    def depth_keys(self):
        return list(self._steps)

    def _make_step(self, key: Any) -> Callable:
        """The (state, batch) -> (state, metrics) step of one table key."""
        if self.pipeline_stages:
            return steps_lib.make_pipeline_train_step(
                self.cfg, self.tcfg, self.spb, depth=key,
                num_stages=self.pipeline_stages,
                schedule=self.pipeline_schedule, group=self.group,
                tensor_parallel=self.tensor_parallel,
                sequence_parallel=self.sequence_parallel, zero2=self.zero2,
                remat=self.remat, shards=self.shards)
        if self.spb.mode == "spatial":
            return steps_lib.make_spatial_step(self.cfg, self.tcfg, self.spb,
                                               remat=self.remat,
                                               group=self._data,
                                               shards=self.shards)
        group = self._data if self._data.size > 1 else None
        if key == "mb":
            return steps_lib.make_temporal_mb_step(
                self.cfg, self.tcfg, self.spb, remat=self.remat, group=group,
                shards=self.shards, model=self._model)
        return steps_lib.make_train_step(self.cfg, self.tcfg, self.spb,
                                         depth=key, remat=self.remat,
                                         group=group, shards=self.shards,
                                         model=self._model)

    def _eager_step(self, key: Any) -> Callable:
        if self.shared_cache:
            return stepcache.GLOBAL.get_or_build(
                self.step_cache_key(key), lambda: self._make_step(key))
        return self._make_step(key)

    def _step_signature(self) -> str:
        """Digest of everything that determines a step except (depth,
        device): the step-cache key's config component, with the AOT key's
        train-config scrub."""
        ident = aot.step_ident(self.cfg, self.tcfg, self.spb,
                               zero1=self.zero1, remat=self.remat)
        blob = json.dumps(ident, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def step_cache_key(self, key: Any):
        """The process-wide step-cache key of one depth entry: (config
        digest, depth tag, device fingerprint), on a submesh its
        fingerprint (``launch/mesh.Submesh.fingerprint``: the device, the
        units, the SMs), and under a data group of several ranks its size
        (and for spatial SPB the rank's level, which picks the step's
        depth)."""
        if not hasattr(self, "_step_sig"):
            self._step_sig = self._step_signature()
        out = (self._step_sig, aot._depth_tag(key),
               stepcache.device_fingerprint(self.device))
        if self.submesh is not None:
            out += (self.submesh.fingerprint(),)
        n = self.group.size
        if self.pipeline_stages:
            out += (("pipeline", self.pipeline_schedule, self.pipeline_stages,
                     self.group.data.size, self.group.stage,
                     self.group.model.size, self.group.model_index,
                     self.tensor_parallel, self.sequence_parallel,
                     self.zero2),)
        elif self._model is not None:
            out += (("grid", self._data.size, self._model.size,
                     self._data.rank % self.spb.k
                     if self.spb.mode == "spatial" else None),)
        elif self.spb.mode == "spatial":
            out += (("group", n, self.group.rank % self.spb.k),)
        elif n > 1:
            out += (("group", n),)
        return out

    def step_fn(self, key: Any) -> Callable:
        """The (state, batch) -> (state, metrics) step of a depth key (None
        = full backprop, int = suffix depth, ``"mb"`` = the cycle).
        Off-cycle depths extend the table on demand, unless it is frozen
        (loaded by :meth:`load_aot`)."""
        if key not in self._steps:
            if self._frozen:
                raise KeyError(
                    f"AOT step table has no entry for depth {key!r}; "
                    f"available: {sorted(map(str, self._steps))}")
            self._steps[key] = self._eager_step(key)
        return self._steps[key]

    def resolve_depth(self, depth: Optional[int]) -> Any:
        """Map a policy-requested depth to a step-table key.

        Depths snap UP to unit boundaries (never less backprop).  When the
        table is frozen, an absent depth resolves to the nearest *deeper*
        entry -- deeper is always convergence-safe -- with a warning; with
        no deeper entry this is a hard error, because silently running full
        backprop instead would erase the SPB savings without any visible
        failure."""
        if depth is None:
            return None
        depth = snap_depth_to_stages(self.cfg, depth, self.pipeline_stages) \
            if self.pipeline_stages else snap_depth(self.cfg, depth)
        if not self._frozen or depth in self._steps:
            return depth
        deeper = sorted(k for k in self._steps
                        if isinstance(k, int) and k >= depth)
        if not deeper:
            raise KeyError(
                f"AOT step table has no entry at or deeper than depth "
                f"{depth}; available: {sorted(map(str, self._steps))} -- "
                f"recompile the table or widen the exported depth set")
        if depth not in self._warned_depths:
            self._warned_depths.add(depth)
            warnings.warn(
                f"AOT step table missing depth {depth}; substituting "
                f"deeper entry {deeper[0]} (more backprop than scheduled)",
                stacklevel=3)
        return deeper[0]

    def depth_key_for_step(self, step: int) -> Any:
        if self.spb.mode in ("off", "spatial"):
            return None             # spatial: the rank's depth is the step's
        if self.spb.mode == "temporal-mb":
            return "mb"             # the step runs the whole depth cycle
        return self.resolve_depth(
            self.group.broadcast_int(self.policy.depth_for_step(step)))

    # -- elastic resizing ---------------------------------------------------

    def resize(self, submesh) -> "SPBEngine":
        """Re-place this session onto another submesh
        (``launch/mesh.make_submeshes``) at an iteration boundary — the
        burst-parallel knob of the reference's ``resize``.

        Returns at once when ``submesh`` is the current one.  Otherwise
        the engine's step entries are dropped and re-resolve through the
        process-wide step cache under the new submesh's fingerprint (a
        return visit builds nothing), a captured or loaded step table is
        abandoned (its graphs were captured on the old share's stream, as
        the reference's frozen executables are placement-specific), and
        :attr:`resizes` counts the move.  What moves:

        * between shares of one card, no bytes: memory is the card's one
          pool.  The new share's stream waits for the old one's, and every
          state tensor is recorded on the new stream, so the caching
          allocator never hands a block of the old stream to new work
          while the new stream still reads it;
        * onto another card, every state tensor (``.to(device)``);
        * on the CPU, nothing.

        A session under a group or a pipeline raises: its ranks are
        processes, not shares of one device."""
        if submesh is self.submesh:
            return self
        if self.pipeline_stages or self.group.size > 1 or \
                self._model is not None:
            raise NotImplementedError(
                "resize: a session under a group or a pipeline has ranks "
                "that are processes; only a session of one process moves "
                "between submeshes")
        old = self.submesh
        old_stream = old.share.stream if old is not None and old.share \
            else (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        self.submesh = submesh
        self._steps, self._compiled, self._graphs = {}, {}, {}
        self._pool, self._frozen, self._warned_depths = None, False, set()
        same_device = device_fingerprint(submesh.device) == \
            device_fingerprint(self.device)
        self.device = submesh.device
        if self.state is not None and not same_device:
            self.attach_state(self.state)
        elif self.state is not None and submesh.share is not None:
            new = submesh.share.stream
            new.wait_stream(old_stream)
            for t in tree_leaves({"params": self.state["params"],
                                  "opt": self.state["opt"]}):
                t.record_stream(new)
        for k in steps_lib.spb_step_keys(self.cfg, self.spb):
            self.step_fn(k)
        self.resizes += 1
        return self

    # -- training ----------------------------------------------------------

    @_placed
    def train_step(self, batch, step: Optional[int] = None, *,
                   depth: Any = _POLICY) -> Dict[str, torch.Tensor]:
        """Run one step on the session state; the policy picks the depth
        unless ``depth`` overrides it (a step-table key: None, a suffix
        depth, or ``"mb"``).  Returns the metrics (0-d tensors: loss, xent,
        moe_aux, grad_norm, lr)."""
        if self.state is None:
            raise RuntimeError("call init_state()/attach_state() first")
        if step is None:
            step = self._auto_step
        key = (self.depth_key_for_step(step) if depth is SPBEngine._POLICY
               else depth)
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        t0 = time.perf_counter()
        self.state, metrics = self.step_fn(key)(self.state, batch)
        if getattr(self.policy, "needs_step_time", False) and \
                self.device.type == "cuda":
            # the card runs the step after the host returns: a policy fed
            # by step times needs the step's end (on a submesh, its share's:
            # the other shares' work is not this step's), at the cost of
            # the host running ahead
            if self.submesh is not None:
                self.submesh.share.stream.synchronize()
            else:
                torch.cuda.synchronize(self.device)
        self.policy.observe(step, time.perf_counter() - t0)
        self.last_depth = key
        self._auto_step = step + 1
        return metrics

    # -- the step table: capture / export / load ---------------------------

    def batch_specs_like(self, batch) -> Dict[str, TensorSpec]:
        """The shape and dtype of each leaf of ``batch`` as
        :meth:`train_step` moves it to the device."""
        return {k: TensorSpec(tuple(v.shape), torch.as_tensor(v).dtype)
                for k, v in batch.items()}

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @_placed
    def compile_table(self, batch_specs, *, depths=None) -> Dict[Any, Any]:
        """Build the step table for batches of ``batch_specs``: on a CUDA
        device one CUDA graph per depth key, captured on the session's
        state (``init_state`` first), which replaces the eager entry; on
        the CPU the eager step functions.  Returns ``{key: entry}``.

        Gradient compression draws its indices from a CPU generator seeded
        per step on the host (``dist/steps.compression_generator``), which
        no graph can capture: a table with it raises, and so does one
        under a data group of several ranks, whose collectives run on the
        host."""
        self._refuse_group("compile_table")
        if self.tcfg.compression != "none":
            raise NotImplementedError(
                f"compile_table: compression={self.tcfg.compression!r} "
                f"draws from a host generator seeded every step, which a "
                f"CUDA graph cannot capture; run such a session eagerly")
        keys = self.depth_keys() if depths is None else list(depths)
        for key in keys:
            if key in self._compiled:
                continue
            if self.device.type == "cuda":
                if self.state is None:
                    raise RuntimeError("compile_table captures on the "
                                       "session's state: call init_state() "
                                       "or attach_state() first")
                entry = _GraphedTrainStep(self, key, batch_specs)
                self._graphs[key] = entry
            else:
                entry = self.step_fn(key)
            self._compiled[key] = entry
            self._steps[key] = entry
        self._specs = dict(batch_specs)
        return dict(self._compiled)

    def _refuse_group(self, what: str) -> None:
        if self.pipeline_stages:
            raise NotImplementedError(
                f"{what} under a pipeline: its point-to-point messages and "
                f"collectives go through the host (gloo), which a CUDA "
                f"graph cannot capture; run the pipeline's steps eagerly")
        if self._model is not None and self.group.size > 1:
            raise NotImplementedError(
                f"{what} under a (data, model) grid of {self._data.size} x "
                f"{self._model.size} ranks: their collectives go through the "
                f"host (gloo), which a CUDA graph cannot capture; run the "
                f"grid's steps eagerly")
        if self.group.size > 1:
            raise NotImplementedError(
                f"{what} under a data group of {self.group.size} ranks: "
                f"their collectives go through the host (gloo), which a CUDA "
                f"graph cannot capture; run the group's steps eagerly")

    def memory_analysis(self, key: Any = None) -> Dict[str, int]:
        """What a captured entry holds on the card (``compile_table``
        first): the bytes its capture added to the engine's pool, the
        pool's bytes after every capture so far, and the allocator's peak
        during its capture.  Unlike XLA's ``memory_analysis`` (argument,
        output and temporary sizes of one program) the pool is shared by
        every entry of the engine, so an entry captured after another
        shows only the growth.  A CPU entry holds no pool: zeros."""
        if key not in self._compiled:
            raise KeyError(f"no compiled entry for depth {key!r}")
        g = self._graphs.get(key)
        if g is None:
            return {"pool_bytes": 0, "pool_total_bytes": 0, "peak_bytes": 0}
        return {"pool_bytes": g.graph.pool_bytes,
                "pool_total_bytes": sum(e.graph.pool_bytes
                                        for e in self._graphs.values()),
                "peak_bytes": g.graph.peak_bytes}

    def aot_cache_path(self, batch_specs, cache_root=None) -> Path:
        root = Path(cache_root) if cache_root else aot.DEFAULT_CACHE
        extra = None if self.submesh is None else \
            {"submesh": self.submesh.fingerprint()}
        return root / aot.cache_key(self.cfg, self.tcfg, self.spb,
                                    self.device, batch_specs,
                                    remat=self.remat, extra=extra)

    def export_aot(self, path, batch_specs=None) -> Path:
        """Store the step table at ``path`` (building it first if needed,
        which takes ``batch_specs``)."""
        if not self._compiled:
            if batch_specs is None:
                raise ValueError("no step table; pass batch_specs")
            self.compile_table(batch_specs)
        sig = aot._shape_sig(self._specs)
        records = {}
        for key in self._compiled:
            g = self._graphs.get(key)
            launches = g.graph.launches if g is not None else {}
            records[key] = {"inputs": sig, "launches": launches,
                            "libs": aot.entry_libs(launches)}
        return aot.export_table(
            records, Path(path), device=self.device,
            meta={"arch": self.cfg.name, "spb_mode": self.spb.mode,
                  "remat": self.remat})

    @_placed
    def load_aot(self, path) -> bool:
        """Restore a stored step table: its kernel libraries load from the
        table (no ``nvcc``), and on a CUDA device each entry is captured
        on the session's state (``init_state`` first), its launches
        checked against the stored ones.  The table is then frozen.
        Returns False when ``path`` has no table, what is there is
        damaged, or it was stored under another recompute policy (a miss:
        the caller builds the table); raises
        ``AOTCompatError`` when the table is intact but was stored by
        another env."""
        self._refuse_group("load_aot")
        if not aot.table_exists(path):
            return False
        try:
            table = aot.import_table(path, expect_device=self.device)
        except (aot.AOTCorruptError, FileNotFoundError):
            return False
        if aot.read_manifest(path)["env"].get("remat", "none") != self.remat:
            return False        # stored under another recompute policy
        if self.device.type == "cuda" and self.state is None:
            raise RuntimeError("load_aot captures on the session's state: "
                               "call init_state() or attach_state() first")
        steps = {}
        for key, record in table.items():
            self._specs = specs = specs_from_signature(record["inputs"])
            if self.device.type == "cuda":
                entry = _GraphedTrainStep(self, key, specs)
                aot.check_launches(f"depth {key!r}",
                                      entry.graph.launches,
                                      record["launches"])
                self._graphs[key] = entry
            else:
                entry = self._eager_step(key)
            steps[key] = self._compiled[key] = entry
        self._steps = steps
        self._frozen = True
        return True
