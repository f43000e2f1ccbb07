"""Depth policies: who decides "how much backprop this iteration"
(the counterpart of ``repro/engine/policies.py``).

* :class:`CyclePolicy` -- the temporal k-cycle (``core/spb.py``'s
  :class:`TemporalSchedule`: warmup, straggler rebalance).
* :class:`CostModelPolicy` -- keeps the snapped depths whose cost-model
  estimate (``jigsaw/costmodel.py``) fits a time budget, and cycles over
  them; the deepest level is always kept so every layer keeps training.
* :class:`SchedulerHookPolicy` -- an outside controller (the JigSaw
  scheduler) sets the next step's depth with :meth:`request_depth` or
  :meth:`request_fraction`: the bridge from scheduling to execution.

Policies emit suffix depths (``None`` = full backprop); the engine snaps
them to its step-table keys.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Protocol, Sequence, runtime_checkable

from repro_torch.config import (ModelConfig, SPBConfig, snap_depth,
                                total_layers)
from repro_torch.core import spb as spb_lib
from repro_torch.jigsaw import costmodel


@runtime_checkable
class DepthPolicy(Protocol):
    """Decides the SPB suffix depth for each training step."""

    def depth_for_step(self, step: int) -> Optional[int]:
        """Suffix depth for ``step`` (None = full backprop)."""
        ...

    def observe(self, step: int, step_time_s: float) -> None:
        """Feedback after a step.  The time is the step's whole time on
        the device only if the policy sets ``needs_step_time = True`` (the
        engine then synchronizes the card before reading the clock);
        otherwise it is the host's dispatch time."""
        ...


class _ObserveMixin:
    needs_step_time = False     # True: the engine synchronizes the card
                                # before it times the step for observe()

    def observe(self, step: int, step_time_s: float) -> None:  # noqa: D401
        pass


class FullBackpropPolicy(_ObserveMixin):
    """Always full backprop (SPB off)."""

    def depth_for_step(self, step: int) -> Optional[int]:
        return None


class CyclePolicy(_ObserveMixin):
    """The temporal k-cycle with warmup, backed by TemporalSchedule; the
    deepest level leads the cycle so every layer trains from step 0."""

    def __init__(self, cfg: ModelConfig, spb: SPBConfig,
                 schedule: Optional[spb_lib.TemporalSchedule] = None):
        self.cfg = cfg
        self.spb = spb
        self.schedule = schedule or spb_lib.make_schedule(cfg, spb)

    def depth_for_step(self, step: int) -> Optional[int]:
        return self.schedule.depth_at(step)

    def rebalance(self, slow_positions: Sequence[int]) -> None:
        """Move the deepest cycle positions off observed-slow slots."""
        self.schedule = self.schedule.rebalance(slow_positions)


class CostModelPolicy(_ObserveMixin):
    """Budget-driven depth selection from cost-model estimates.

    A step at suffix depth d is estimated as ``profile.task_time(d / L)``
    (``profile`` is a :class:`repro_torch.jigsaw.costmodel.ModelProfile`).
    The policy keeps the snapped depths whose estimate fits
    ``time_budget_frac * task_time(1.0)``, plus the deepest snapped depth
    unconditionally, and cycles over the kept set."""

    def __init__(self, cfg: ModelConfig, spb: SPBConfig, profile,
                 time_budget_frac: float = 0.75, warmup_steps: int = 0):
        if not 0.0 < time_budget_frac <= 1.0:
            raise ValueError(f"time_budget_frac must be in (0, 1], got "
                             f"{time_budget_frac}")
        self.cfg = cfg
        self.spb = spb
        self.profile = profile
        self.time_budget_frac = time_budget_frac
        L = total_layers(cfg)
        budget = time_budget_frac * profile.task_time(1.0)
        depths = sorted(set(spb_lib.snapped_depths(cfg, spb)))
        kept = [d for d in depths if profile.task_time(d / L) <= budget]
        if depths[-1] not in kept:
            kept.append(depths[-1])
        self.depths = tuple(kept)
        self.schedule = spb_lib.TemporalSchedule(self.depths,
                                                 warmup_steps=warmup_steps)

    def depth_for_step(self, step: int) -> Optional[int]:
        return self.schedule.depth_at(step)


class SchedulerHookPolicy(_ObserveMixin):
    """External depth control: a scheduler calls :meth:`request_depth` (or
    :meth:`request_fraction` with the paper's per-worker backprop fraction)
    and the engine runs that depth from the next step on.  Requests stick
    until replaced; with none the policy asks ``default`` (full backprop
    when there is no default)."""

    def __init__(self, cfg: ModelConfig, spb: SPBConfig,
                 default: Optional[DepthPolicy] = None):
        self.cfg = cfg
        self.spb = spb
        self.default = default
        self._requested: Optional[int] = None
        self._has_request = False

    def request_depth(self, depth: Optional[int]) -> Optional[int]:
        """Set the suffix depth of the next steps (None = full backprop).
        Returns the snapped depth that will run."""
        if depth is not None:
            depth = snap_depth(self.cfg, depth)
        self._requested = depth
        self._has_request = True
        return depth

    def request_fraction(self, fraction: float) -> Optional[int]:
        """Backprop ``fraction`` of the layers, rounded up (worker j of k
        requests (j+1)/k)."""
        L = total_layers(self.cfg)
        return self.request_depth(max(1, math.ceil(fraction * L)))

    def clear(self) -> None:
        self._requested = None
        self._has_request = False

    def depth_for_step(self, step: int) -> Optional[int]:
        if self._has_request:
            return self._requested
        if self.default is not None:
            return self.default.depth_for_step(step)
        return None

    def observe(self, step: int, step_time_s: float) -> None:
        if self.default is not None:
            self.default.observe(step, step_time_s)


def make_policy(name: str, cfg: ModelConfig, spb: SPBConfig, *,
                profile=None, time_budget_frac: float = 0.75,
                remat: str = "none") -> DepthPolicy:
    """CLI-level factory: 'cycle' | 'costmodel' | 'hook' | 'full'.  A
    'costmodel' policy reads the dry run's records of the layer-recompute
    policy ``remat``."""
    if spb.mode in ("off", "spatial", "temporal-mb") or name == "full":
        # the depth lives inside the step, or there is none to pick
        return FullBackpropPolicy()
    if name == "cycle":
        return CyclePolicy(cfg, spb)
    if name == "costmodel":
        if profile is None:
            # the dry run's profile of this very config (its layers and
            # experts too: a cut keeps its arch's name), else the paper's
            profile, counted = costmodel.h100_profile(cfg, remat=remat)
            db = costmodel.v100_profiles()
            if profile is not None and not counted:
                warnings.warn(
                    f"the cost-model profile of {cfg.name!r} comes from one "
                    f"dry-run depth, its forward:backward split assumed 1:2 "
                    f"-- dry-run two depths of it (launch/dryrun.py) to "
                    f"count the split", stacklevel=2)
            elif profile is None:
                profile = db.get(cfg.name)
            if profile is None:
                # a paper V100 profile keeps the policy usable, but its
                # forward:backward ratio is not this model's
                profile = db["resnet50"]
                warnings.warn(
                    f"no cost-model profile for {cfg.name!r}; falling back "
                    f"to the paper's resnet50 V100 profile -- run "
                    f"launch/dryrun.py to derive a real one", stacklevel=2)
        return CostModelPolicy(cfg, spb, profile,
                               time_budget_frac=time_budget_frac,
                               warmup_steps=spb.warmup_steps)
    if name == "hook":
        return SchedulerHookPolicy(cfg, spb, default=CyclePolicy(cfg, spb))
    raise ValueError(f"unknown depth policy {name!r}; "
                     f"known: cycle, costmodel, hook, full")
