"""One event-loop runtime for cluster scheduling, sim and live (the
counterpart of ``repro/cluster``).

``ClusterRuntime`` (``runtime.py``) owns the clock, event heap, ready
queue, dependency tracking and migration accounting; ``Scheduler.place()``
policies (``repro_torch.jigsaw.schedulers``) drive two interchangeable
execution backends:

* :class:`SimBackend` — the wall-clock-free DES
  (``repro_torch.jigsaw.simulator.simulate`` is a shim over it).
* :class:`LiveBackend` (``live.py``) — a pool of real ``SPBEngine``
  sessions, one per :class:`JobSpec`, on one device; each placed task
  runs as a real train step at the worker's SPB depth and the measured
  duration feeds back into the scheduler's cost model.

Fault tolerance (``faults.py`` / ``health.py``): a seeded
:class:`FaultPlan` injects machine crashes, transient task failures and
stragglers into the shared event loop on the *virtual* clock, so the same
plan drives either backend; :class:`HealthMonitor` + :class:`DegradePolicy`
turn detected stragglers into shallower SPB depths instead of gang stalls.

``live`` imports torch and the engine; it is loaded lazily so pure-DES
consumers (schedulers, trace generators) import only the standard library.
"""
from repro_torch.cluster.faults import (  # noqa: F401
    FaultPlan, MachineCrash, Straggler, TaskFailure, fail_keys_for)
from repro_torch.cluster.health import (  # noqa: F401
    DegradePolicy, HealthMonitor)
from repro_torch.cluster.runtime import (  # noqa: F401
    Assignment, ClusterRuntime, ClusterState, ExecutionBackend, JobSpec,
    Scheduler, SimBackend, SimResult, Task, TaskContext, TaskFailedError,
    WorkerSpec)

_LIVE = ("LiveBackend", "LiveJob", "make_live_job")

__all__ = [
    "Assignment", "ClusterRuntime", "ClusterState", "DegradePolicy",
    "ExecutionBackend", "FaultPlan", "HealthMonitor", "JobSpec",
    "MachineCrash", "Scheduler", "SimBackend", "SimResult", "Straggler",
    "Task", "TaskContext", "TaskFailedError", "TaskFailure", "WorkerSpec",
    "fail_keys_for",
    *_LIVE,
]


def __getattr__(name):
    if name in _LIVE:
        from repro_torch.cluster import live
        return getattr(live, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
