"""HFTA-style horizontal fusion: J same-shaped jobs, one vmapped step
(the counterpart of ``repro/engine/fused.py``).

Swarms of small tenant jobs waste a card twice: each job under-fills it,
and each pays its own kernel launches and scheduling turn.  Horizontal
fusion (Wang et al., HFTA) stacks the *models* instead: J jobs with
identical (config, SPB, optimizer) shapes train as one
``torch.func.vmap``-ed step whose state carries a leading ``(J, ...)``
jobs axis.  One step, one scheduling slot, J jobs advancing in lockstep,
with per-job metrics unstacked on poll.

Each step-table entry is ``vmap`` of a functional step of
``dist/steps.py`` (gradients from ``torch.func.vjp`` over the params
tree).  Every hand-written kernel's ``autograd.Function`` has a vmap rule
that folds the jobs axis into the batch axis (``kernels/ops.py``), so a
fused step launches each kernel as often as one solo step does, at J x B
rows.  The optimizer updates the stacked state in place.  Under
``remat="full"`` or ``"dots"`` each step sweeps the live repeats with
``torch.func.vjp`` (``lm.swept_grads``), which ``vmap`` batches as it
batches the plain step; under ``"dots"`` the sweep's forward keeps the
product outputs of every job (J x B rows: J times one solo step's kept
bytes) and the recompute replays them.  The group
shares each iteration's SPB depth (one step runs all J jobs), so the
scheduler degrades or deepens the group as a unit.  ``randomness="same"``:
the compressors draw one stream for every job, as the reference's
vmapped step closes over one key.

    eng = FusedEngine(reduced_config("yi-6b"), TrainConfig(),
                      SPBConfig(mode="temporal", k=2), num_jobs=3,
                      device="cpu")
    eng.init_states([0, 1, 2])      # member j == SPBEngine.init_state(j)
    eng.depth_keys()                # [None, 2, 4]
    metrics = eng.train_step(stack_batches(batches), step)
    eng.per_job_metrics(metrics)    # J dicts
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine, State, _placed
from repro_torch.tree import tree_leaves, tree_map


def stack_batches(batches: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-job batches onto a leading jobs axis (tensors with
    ``torch.stack``, anything else with ``np.stack``)."""
    def stack(*xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        return np.stack(xs)
    return {k: stack(*(b[k] for b in batches)) for k in batches[0]}


class FusedEngine(SPBEngine):
    """One training session running ``num_jobs`` stacked tenants on one
    device, or on one submesh (``submesh=``; :meth:`~SPBEngine.resize`
    moves the stacked state as it moves a solo one, the counterpart of the
    reference's ``_bind_mesh`` override)."""

    def __init__(self, cfg, tcfg, spb_cfg=None, *, num_jobs: int, **kw):
        if num_jobs < 1:
            raise ValueError(f"num_jobs must be >= 1, got {num_jobs}")
        self.num_jobs = num_jobs
        super().__init__(cfg, tcfg, spb_cfg, **kw)

    def _make_step(self, key: Any) -> Callable:
        if key == "mb":
            fn = steps_lib.make_functional_temporal_mb_step(
                self.cfg, self.tcfg, self.spb, remat=self.remat)
        else:
            fn = steps_lib.make_functional_train_step(
                self.cfg, self.tcfg, self.spb, depth=key, remat=self.remat)
        # the step count, the schedule and the update flag are one for the
        # group: no jobs axis
        fused = torch.func.vmap(fn, in_dims=(0, 0, None, 0, None, None),
                                randomness="same")

        def step(state: State, batch, *, sched=None, update: bool = True):
            params, opt, metrics = fused(state["params"], state["opt"],
                                         state["step"], batch, sched, update)
            return {"params": params, "opt": opt,
                    "step": state["step"] + int(update)}, metrics

        return step

    def step_cache_key(self, key: Any):
        return super().step_cache_key(key) + (("fused", self.num_jobs),)

    # -- stacked state lifecycle -------------------------------------------

    def init_state(self, seed: int) -> State:
        """One seed for the group: ``num_jobs`` per-job seeds drawn from
        it (the reference splits one key)."""
        seeds = np.random.SeedSequence(seed).generate_state(self.num_jobs)
        return self.init_states([int(s) for s in seeds])

    @_placed
    def init_states(self, seeds: Sequence[int]) -> State:
        """Initialize the J tenants: member j equals
        ``SPBEngine.init_state(seeds[j])``.  Each solo state is built and
        copied into the stacked one in turn, so the peak holds the stack
        and one tenant."""
        if len(seeds) != self.num_jobs:
            raise ValueError(f"{len(seeds)} seeds for {self.num_jobs} jobs")
        self.state = stacked = None
        for j, seed in enumerate(seeds):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            solo = steps_lib.init_train_state(gen, self.cfg, self.tcfg,
                                              self.device)
            solo = {"params": solo["params"], "opt": solo["opt"]}
            if stacked is None:
                stacked = tree_map(lambda t: torch.empty(
                    (self.num_jobs,) + tuple(t.shape), dtype=t.dtype,
                    device=t.device), solo)
            tree_map(lambda dst, src: dst[j].copy_(src.detach()), stacked,
                     solo)
            del solo
        return self._adopt({**stacked, "step": 0})

    @_placed
    def attach_state(self, state: State) -> State:
        """Adopt a stacked state, moved to the session's device.  The
        params are plain tensors: the functional step takes their
        gradients with ``torch.func.vjp``."""
        J = {t.shape[0] for t in tree_leaves(state["params"])}
        if J != {self.num_jobs}:
            raise ValueError(f"expected a jobs axis of {self.num_jobs}, got "
                             f"leading dims {sorted(J)}")
        move = lambda t: t.detach().to(self.device)
        return self._adopt({"params": tree_map(move, state["params"]),
                            "opt": tree_map(move, state["opt"]),
                            "step": int(state["step"])})

    # -- per-job views ------------------------------------------------------

    def per_job_metrics(self, metrics: Dict[str, torch.Tensor]
                        ) -> List[Dict[str, torch.Tensor]]:
        """Unstack one fused step's metrics into J per-job dicts (host
        tensors: one copy to the host per metric)."""
        host = {k: v.detach().cpu() for k, v in metrics.items()}
        return [{k: v[i] for k, v in host.items()}
                for i in range(self.num_jobs)]
