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
"""
from __future__ import annotations

import hashlib
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig, SPBConfig, TrainConfig, snap_depth
from repro_torch.core import spb as spb_lib
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.engine import aot, graphs, stepcache
from repro_torch.engine.policies import DepthPolicy, make_policy
from repro_torch.dist.group import DataGroup
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_map

State = Dict[str, Any]


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
            device=dev, pool=engine._graph_pool(), warmup=warmup)

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
                 group: Optional[DataGroup] = None, zero1: bool = True):
        self.cfg = cfg
        self.tcfg = tcfg
        self.spb = spb_cfg or SPBConfig()
        self.remat = lm.resolve_remat(remat)
        if group is None:
            self.device = resolve_device(device)
            group = DataGroup(device=self.device)
        elif device is not None and \
                resolve_device(device).type != group.device.type:
            raise ValueError(f"device={device!r} disagrees with the data "
                             f"group's {group.device}")
        else:
            self.device = group.device
        self.group = group
        self.zero1 = zero1
        self.mesh = sharding.mesh_for(group)
        self.state_shapes = steps_lib.train_state_shapes(cfg, tcfg)
        self.state_specs = sharding.state_pspec(self.state_shapes, self.mesh,
                                                zero1=zero1)
        self.shards = sharding.opt_slices(self.state_shapes, self.state_specs,
                                          self.mesh, group.rank)
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

    # -- state lifecycle ---------------------------------------------------

    def init_state(self, seed: int) -> State:
        """Random params from a generator seeded with ``seed`` on the
        session's device, fresh optimizer state (this rank's slices under
        ZeRO-1)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._adopt(steps_lib.init_train_state(
            gen, self.cfg, self.tcfg, self.device, self.shards))

    def attach_state(self, state: State) -> State:
        """Adopt an externally built state, moved to the session's device
        (params become leaves that require grad).  Under ZeRO-1 a whole
        optimizer leaf is cut to this rank's slice (a copy); a leaf that
        already has the slice's shape is taken as it is."""
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
            "params": tree_map(param, state["params"]),
            "opt": {k: tree_map(own, sub, self.shards) if self.shards
                    else tree_map(lambda t: t.to(self.device), sub)
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
        if self.spb.mode == "spatial":
            return steps_lib.make_spatial_step(self.cfg, self.tcfg, self.spb,
                                               remat=self.remat,
                                               group=self.group,
                                               shards=self.shards)
        group = self.group if self.group.size > 1 else None
        if key == "mb":
            return steps_lib.make_temporal_mb_step(
                self.cfg, self.tcfg, self.spb, remat=self.remat, group=group,
                shards=self.shards)
        return steps_lib.make_train_step(self.cfg, self.tcfg, self.spb,
                                         depth=key, remat=self.remat,
                                         group=group, shards=self.shards)

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
        digest, depth tag, device fingerprint), and under a data group of
        several ranks its size (and for spatial SPB the rank's level, which
        picks the step's depth)."""
        if not hasattr(self, "_step_sig"):
            self._step_sig = self._step_signature()
        out = (self._step_sig, aot._depth_tag(key),
               stepcache.device_fingerprint(self.device))
        n = self.group.size
        if self.spb.mode == "spatial":
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
        depth = snap_depth(self.cfg, depth)
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

    # -- training ----------------------------------------------------------

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
            # by step times needs the step's end, at the cost of the
            # host running ahead
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
        return root / aot.cache_key(self.cfg, self.tcfg, self.spb,
                                    self.device, batch_specs,
                                    remat=self.remat)

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
