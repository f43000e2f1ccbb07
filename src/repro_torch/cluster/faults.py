"""Deterministic fault injection for the cluster runtime.
(The counterpart of ``repro/cluster/faults.py``, the same code.)

Real clusters lose work at exactly the granularity JigSaw schedules at —
iterations — to machine crashes, transient task failures, and stragglers.
A :class:`FaultPlan` is a *seeded, virtual-time* description of those
events, injected into
:class:`~repro_torch.cluster.runtime.ClusterRuntime`'s event loop, so the
same plan drives both the DES (``SimBackend``) and a real engine pool
(``LiveBackend``): the runtime clock is virtual in both backends, which
is what makes the injection backend-agnostic and the fault invariant
suite shared.

Three fault species:

* :class:`MachineCrash` — machine ``m`` dies at ``at`` and rejoins after
  ``repair_s`` (MTTR).  Tasks running or queued on it are killed; every
  worker whose model state was resident on it loses that state, so its
  job rolls back to the last checkpointed iteration (lost work is priced
  honestly in ``SimResult``: goodput, lost iterations, recovery time).
* :class:`TaskFailure` — one specific ``(job, worker, iteration)`` task
  fails transiently partway through its first attempt (OOM, NCCL hiccup,
  preempted container); the runtime charges the wasted partial run and
  re-enqueues the task, which succeeds on retry.
* :class:`Straggler` — machine ``m`` runs ``factor`` x slower inside
  ``[start, until)``.  Detection and the SPB-depth response live in
  :mod:`repro_torch.cluster.health`.

Plans are value objects: build one from explicit events, from the
compact CLI spec grammar (:meth:`FaultPlan.parse`), or sample one with
:meth:`FaultPlan.generate` (Poisson crashes + uniform straggle windows,
fully determined by the seed).

>>> plan = FaultPlan.parse("crash:0@5+3;slow:1@2-20x4;fail:1.0@2")
>>> plan.crashes[0].machine, plan.crashes[0].at, plan.crashes[0].repair_s
(0, 5.0, 3.0)
>>> plan.slowdown(1, 10.0)
4.0
>>> plan.slowdown(1, 25.0)      # outside the window
1.0
>>> plan.fails(job_id=1, worker_id=0, iteration=2)
True
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MachineCrash:
    machine: int
    at: float                 # virtual seconds
    repair_s: float           # MTTR: machine rejoins at ``at + repair_s``

    @property
    def repaired_at(self) -> float:
        return self.at + self.repair_s


@dataclass(frozen=True)
class TaskFailure:
    """First attempt of this (job, worker, iteration) task fails after
    ``frac`` of its duration; the retry runs clean."""
    job_id: int
    worker_id: int
    iteration: int
    frac: float = 0.5


@dataclass(frozen=True)
class Straggler:
    machine: int
    start: float
    until: float
    factor: float             # task durations multiply by this


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults over one cluster session.

    ``restore_s`` is the checkpoint-restore cost charged to a job's
    first re-spawned iteration after a rollback (loading weights +
    optimizer state onto the replacement machine).
    """
    crashes: Tuple[MachineCrash, ...] = ()
    task_failures: Tuple[TaskFailure, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    restore_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "crashes",
                           tuple(sorted(self.crashes, key=lambda c: c.at)))
        object.__setattr__(self, "task_failures", tuple(self.task_failures))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))
        object.__setattr__(self, "_fail_keys", frozenset(
            (f.job_id, f.worker_id, f.iteration) for f in self.task_failures))

    # -- queries the runtime makes ----------------------------------------

    def slowdown(self, machine: int, t: float) -> float:
        """Compound slowdown factor for a task starting on ``machine`` at
        virtual time ``t`` (1.0 = healthy)."""
        f = 1.0
        for s in self.stragglers:
            if s.machine == machine and s.start <= t < s.until:
                f *= s.factor
        return f

    def fails(self, job_id: int, worker_id: int, iteration: int) -> bool:
        return (job_id, worker_id, iteration) in self._fail_keys

    def failure_for(self, job_id: int, worker_id: int,
                    iteration: int) -> Optional[TaskFailure]:
        for f in self.task_failures:
            if (f.job_id, f.worker_id, f.iteration) == \
                    (job_id, worker_id, iteration):
                return f
        return None

    @property
    def empty(self) -> bool:
        return not (self.crashes or self.task_failures or self.stragglers)

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, *, restore_s: float = 0.0) -> "FaultPlan":
        """Compact CLI grammar, ';'-separated events:

        * ``crash:M@T+R``   — machine M crashes at t=T, repairs after R
        * ``slow:M@A-BxF``  — machine M runs Fx slower for t in [A, B)
        * ``fail:J.W@I``    — job J worker W's iteration-I task fails once

        >>> FaultPlan.parse("crash:1@10+5").crashes
        (MachineCrash(machine=1, at=10.0, repair_s=5.0),)
        """
        crashes: List[MachineCrash] = []
        fails: List[TaskFailure] = []
        slows: List[Straggler] = []
        for ev in filter(None, (e.strip() for e in spec.split(";"))):
            kind, _, rest = ev.partition(":")
            try:
                if kind == "crash":
                    m, _, tr = rest.partition("@")
                    t, _, r = tr.partition("+")
                    crashes.append(MachineCrash(int(m), float(t),
                                                float(r or "inf")))
                elif kind == "slow":
                    m, _, w = rest.partition("@")
                    ab, _, f = w.partition("x")
                    a, _, b = ab.partition("-")
                    slows.append(Straggler(int(m), float(a),
                                           float(b or "inf"), float(f)))
                elif kind == "fail":
                    jw, _, i = rest.partition("@")
                    j, _, w = jw.partition(".")
                    fails.append(TaskFailure(int(j), int(w), int(i)))
                else:
                    raise ValueError(f"unknown fault kind {kind!r}")
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"bad fault event {ev!r} (grammar: crash:M@T+R | "
                    f"slow:M@A-BxF | fail:J.W@I): {e}") from None
        return cls(crashes=tuple(crashes), task_failures=tuple(fails),
                   stragglers=tuple(slows), restore_s=restore_s)

    @classmethod
    def generate(cls, *, machines: int, duration_s: float, seed: int = 0,
                 crash_rate: float = 0.0, mttr_s: float = 60.0,
                 slow_rate: float = 0.0, slow_factor: float = 3.0,
                 slow_duration_s: float = 120.0,
                 fail_keys: Tuple[Tuple[int, int, int], ...] = (),
                 fail_prob: float = 0.0, restore_s: float = 0.0
                 ) -> "FaultPlan":
        """Sample a plan, fully determined by ``seed``.

        ``crash_rate`` / ``slow_rate``: expected events *per machine*
        over the whole ``duration_s`` window (Poisson counts, uniform
        times).  ``fail_keys`` enumerates candidate (job, worker,
        iteration) task identities; each fails independently with
        ``fail_prob``.

        >>> p = FaultPlan.generate(machines=4, duration_s=100, seed=7,
        ...                        crash_rate=0.5, mttr_s=10)
        >>> p == FaultPlan.generate(machines=4, duration_s=100, seed=7,
        ...                        crash_rate=0.5, mttr_s=10)
        True
        """
        rng = random.Random(seed)
        crashes: List[MachineCrash] = []
        slows: List[Straggler] = []
        for m in range(machines):
            for _ in range(_poisson(rng, crash_rate)):
                at = rng.uniform(0.0, duration_s)
                crashes.append(MachineCrash(
                    m, at, rng.expovariate(1.0 / mttr_s)))
            for _ in range(_poisson(rng, slow_rate)):
                at = rng.uniform(0.0, duration_s)
                slows.append(Straggler(m, at, at + slow_duration_s,
                                       slow_factor))
        fails = [TaskFailure(j, w, i) for (j, w, i) in fail_keys
                 if rng.random() < fail_prob]
        return cls(crashes=tuple(crashes), task_failures=tuple(fails),
                   stragglers=tuple(slows), restore_s=restore_s)


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's algorithm (lam is small here: events per machine-window)."""
    if lam <= 0.0:
        return 0
    L = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= L:
            return k
        k += 1


def fail_keys_for(jobs) -> Tuple[Tuple[int, int, int], ...]:
    """All (job, worker, iteration) task identities of a job list —
    the candidate set for ``FaultPlan.generate(fail_keys=...)``."""
    keys = []
    for j in jobs:
        for it in range(j.iterations):
            for w in range(j.num_workers):
                keys.append((j.job_id, w, it))
    return tuple(keys)
