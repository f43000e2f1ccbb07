"""Machine health monitoring and SPB-depth graceful degradation.
(The counterpart of ``repro/cluster/health.py``, the same code.)

SPB gives the cluster a recovery knob no ordinary scheduler has: a
straggling (or freshly repaired) worker can be snapped to a *shallower*
backprop depth instead of stalling the whole gang at the iteration
barrier.  This module is the detection + response pair:

* :class:`HealthMonitor` — per-machine EMA of the ratio
  ``observed_duration / scheduler_estimate`` (the same measured-duration
  feedback ``LiveBackend`` already produces; the DES feeds it the
  fault-inflated virtual durations).  Normalizing by the estimate makes
  machines comparable across heterogeneous jobs and depths: a healthy
  machine hovers near 1.0, a straggler tracks its slowdown factor.
* :class:`DegradePolicy` — maps a worker's planned backprop fraction to
  a degraded one while its machine is flagged (``frac * scale``,
  floored), and prices the resulting speedup with the paper's
  ``fwd + frac * bwd`` cost shape so the DES and the live engine agree
  on what degradation buys.

The runtime feeds observations and consults both on every placement; the
degraded fraction reaches real execution through the job's
``SchedulerHookPolicy`` (``LiveBackend`` requests it right before the
step), and reaches the DES as a duration scale.

>>> mon = HealthMonitor(threshold=2.0, min_samples=2)
>>> for _ in range(3):
...     mon.observe(0, estimate_s=1.0, observed_s=1.0)
...     mon.observe(1, estimate_s=1.0, observed_s=4.0)
>>> mon.is_straggler(0), mon.is_straggler(1)
(False, True)
>>> pol = DegradePolicy(scale=0.5, min_frac=0.25)
>>> pol.degrade(1.0)
0.5
>>> round(pol.time_scale(1.0, 0.5), 3)     # fwd:bwd = 1:2 -> 2/3 the time
0.667
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


class HealthMonitor:
    """Per-machine EMA step-time ratios with straggler flagging.

    A machine is flagged when its EMA ratio exceeds ``threshold`` times
    the median EMA of the *other* reporting machines (leave-one-out, so
    one straggler cannot hide by dragging the median up in a small
    cluster, and a uniformly slow cluster flags nobody), after at least
    ``min_samples`` observations.  ``alpha`` weights the newest
    observation.
    """

    def __init__(self, *, alpha: float = 0.4, threshold: float = 1.75,
                 min_samples: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1, got {threshold}")
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.ema: Dict[int, float] = {}
        self.samples: Dict[int, int] = {}
        self.flagged_total = 0          # times is_straggler() said yes

    def observe(self, machine: int, *, estimate_s: float,
                observed_s: float) -> None:
        """Record one finished task: the duration the scheduler priced
        (``estimate_s``) vs what the machine delivered."""
        if estimate_s <= 0.0:
            return
        r = observed_s / estimate_s
        prev = self.ema.get(machine)
        self.ema[machine] = (r if prev is None
                             else (1 - self.alpha) * prev + self.alpha * r)
        self.samples[machine] = self.samples.get(machine, 0) + 1

    def _baseline(self, machine: int) -> Optional[float]:
        """Median EMA of every *other* reporting machine."""
        vals = sorted(v for m, v in self.ema.items() if m != machine)
        if not vals:
            return None
        n = len(vals)
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    def is_straggler(self, machine: int) -> bool:
        if self.samples.get(machine, 0) < self.min_samples:
            return False
        slow = self._is_slow_no_count(machine)
        if slow:
            self.flagged_total += 1
        return slow

    def stragglers(self) -> List[int]:
        """Machines currently flagged (sorted)."""
        return sorted(m for m in self.ema
                      if self.samples.get(m, 0) >= self.min_samples
                      and self._is_slow_no_count(m))

    def _is_slow_no_count(self, machine: int) -> bool:
        med = self._baseline(machine)
        return bool(med and self.ema[machine] > self.threshold * med)

    def summary(self) -> Dict[int, dict]:
        return {m: {"ema_ratio": round(self.ema[m], 4),
                    "samples": self.samples.get(m, 0),
                    "straggler": self._is_slow_no_count(m)}
                for m in sorted(self.ema)}


@dataclass
class DegradePolicy:
    """Snap a straggler's worker to a shallower SPB depth.

    ``scale`` multiplies the worker's planned backprop fraction while
    its machine is flagged; ``min_frac`` floors it so every task keeps
    training *some* suffix.  ``fwd_weight`` is the forward pass's share
    of a full-depth step (the paper's fwd:bwd ~ 1:2 -> 1/3), used to
    price the degraded task: ``time(frac) = fwd_weight +
    (1 - fwd_weight) * frac`` of a full step.
    """
    scale: float = 0.5
    min_frac: float = 0.25
    fwd_weight: float = 1.0 / 3.0
    applied: int = field(default=0, compare=False)

    def degrade(self, frac: float) -> float:
        """The degraded backprop fraction for a planned ``frac``."""
        return max(self.min_frac, frac * self.scale)

    def time_scale(self, frac: float, degraded: float) -> float:
        """Duration multiplier when a task planned at ``frac`` runs at
        ``degraded`` instead (both in (0, 1])."""
        full = self.fwd_weight + (1 - self.fwd_weight) * frac
        less = self.fwd_weight + (1 - self.fwd_weight) * degraded
        return less / full
