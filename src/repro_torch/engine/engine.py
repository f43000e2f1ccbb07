"""SPBEngine on one device: train state + depth policy + per-depth step
table (the single-device surface of ``repro/engine/engine.py``).

PyTorch runs eagerly, so there is no table to compile: a step-table entry
is a plain function of ``dist/steps.py`` and the session keeps the state
on its device, updated in place.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.config import ModelConfig, SPBConfig, TrainConfig, snap_depth
from repro_torch.device import resolve_device
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.policies import DepthPolicy, make_policy
from repro_torch.tree import tree_map

State = Dict[str, Any]


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
                 policy: Optional[DepthPolicy] = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.spb = spb_cfg or SPBConfig()
        self.device = resolve_device(device)
        self.policy = policy or make_policy("cycle", cfg, self.spb)
        self._steps: Dict[Any, Callable] = {
            k: self._make_step(k)
            for k in steps_lib.spb_step_keys(cfg, self.spb)}
        self.state: Optional[State] = None
        self.last_depth: Any = None
        self._auto_step = 0

    # -- state lifecycle ---------------------------------------------------

    def init_state(self, seed: int) -> State:
        """Random params from a generator seeded with ``seed`` on the
        session's device, fresh optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = steps_lib.init_train_state(gen, self.cfg, self.tcfg,
                                                self.device)
        return self.state

    def attach_state(self, state: State) -> State:
        """Adopt an externally built state, moved to the session's device
        (params become leaves that require grad)."""
        def param(t):
            return t.detach().to(self.device).requires_grad_(True)

        self.state = {
            "params": tree_map(param, state["params"]),
            "opt": tree_map(lambda t: t.to(self.device), state["opt"]),
            "step": int(state["step"]),
        }
        return self.state

    @property
    def step_count(self) -> int:
        return self.state["step"] if self.state is not None else 0

    # -- step table --------------------------------------------------------

    def depth_keys(self):
        return list(self._steps)

    def _make_step(self, key: Any) -> Callable:
        """The (state, batch) -> (state, metrics) step of one table key."""
        if key == "mb":
            return steps_lib.make_temporal_mb_step(self.cfg, self.tcfg,
                                                   self.spb)
        return steps_lib.make_train_step(self.cfg, self.tcfg, self.spb,
                                         depth=key)

    def step_fn(self, key: Any) -> Callable:
        if key not in self._steps:
            # off-cycle depths extend the table on demand
            self._steps[key] = self._make_step(key)
        return self._steps[key]

    def resolve_depth(self, depth: Optional[int]) -> Any:
        """Depths snap UP to unit boundaries (never less backprop)."""
        return None if depth is None else snap_depth(self.cfg, depth)

    def depth_key_for_step(self, step: int) -> Any:
        if self.spb.mode == "off":
            return None
        if self.spb.mode == "temporal-mb":
            return "mb"             # the step runs the whole depth cycle
        return self.resolve_depth(self.policy.depth_for_step(step))

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
