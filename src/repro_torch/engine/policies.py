"""Depth policies: who decides "how much backprop this iteration"
(``repro/engine/policies.py``: the full-backprop and cycle policies).

Policies emit suffix depths (``None`` = full backprop); the engine snaps
them to its step-table keys.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence, runtime_checkable

from repro_torch.config import ModelConfig, SPBConfig
from repro_torch.core import spb as spb_lib


@runtime_checkable
class DepthPolicy(Protocol):
    """Decides the SPB suffix depth for each training step."""

    def depth_for_step(self, step: int) -> Optional[int]:
        """Suffix depth for ``step`` (None = full backprop)."""
        ...

    def observe(self, step: int, step_time_s: float) -> None:
        """Feedback after a step (the host time of the step's dispatch)."""
        ...


class _ObserveMixin:
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


def make_policy(name: str, cfg: ModelConfig, spb: SPBConfig) -> DepthPolicy:
    """CLI-level factory: 'cycle' | 'full' (the other JAX policies are not
    ported yet)."""
    if spb.mode == "off" or name == "full":
        return FullBackpropPolicy()
    if name == "cycle":
        return CyclePolicy(cfg, spb)
    raise ValueError(f"unknown or unported depth policy {name!r}; "
                     f"the port has: cycle, full")
