"""Discrete-event cluster simulator — a shim over ``repro_torch.cluster``
(the counterpart of ``repro/jigsaw/simulator.py``).

The event loop, clock, and machine/ready-queue bookkeeping live in
``repro_torch.cluster.runtime``: the same :class:`ClusterRuntime` that
runs this DES backend also drives a live multi-job ``SPBEngine`` pool
(``repro_torch.cluster.live.LiveBackend``), so ``Scheduler.place()`` policies
are backend-agnostic.  This module keeps the reference's import path and
the one-call :func:`simulate` entry point; all entities are re-exported
unchanged and the DES behavior (event ordering, horizon semantics,
migration accounting) is identical.
"""
from __future__ import annotations

from typing import List

from repro_torch.cluster.runtime import (  # noqa: F401  (re-exported API)
    Assignment, ClusterRuntime, ClusterState, ExecutionBackend, JobSpec,
    Scheduler, SimBackend, SimResult, Task, WorkerSpec)

__all__ = [
    "Assignment", "ClusterRuntime", "ClusterState", "ExecutionBackend",
    "JobSpec", "Scheduler", "SimBackend", "SimResult", "Task", "WorkerSpec",
    "simulate",
]


def simulate(jobs: List[JobSpec], scheduler: Scheduler, *,
             num_machines: int = 45, machine_mem_gb: float = 16.0,
             gamma: float = 2.0, max_time: float = 10e6,
             horizon: float = 60.0, record_schedule: bool = False
             ) -> SimResult:
    """Run the DES to completion (a ``ClusterRuntime`` + ``SimBackend``)."""
    return ClusterRuntime(
        jobs, scheduler, SimBackend(), num_machines=num_machines,
        machine_mem_gb=machine_mem_gb, gamma=gamma, max_time=max_time,
        horizon=horizon, record_schedule=record_schedule).run()
