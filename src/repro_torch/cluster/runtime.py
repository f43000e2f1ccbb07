"""Backend-agnostic cluster runtime: one event loop for DES and live SPB
(the counterpart of ``repro/cluster/runtime.py``, the same code).

Entities mirror the paper (§3/§4.2): a *job* is a set of parallel workers
iterating synchronously; a *task* is one worker's work for one iteration
(its duration/memory depend on the worker's SPB backprop fraction);
*machines* run one task at a time and moving a worker to a new machine
costs ``gamma * model_size`` (model transfer), which schedulers must
account for.  Synchronous SGD dependency: iteration i+1 tasks become
ready only when ALL of iteration i's tasks for that job finished.

The split is between *deciding* and *doing*:

* :class:`ClusterRuntime` owns the clock, event heap, ready queue,
  per-job iteration dependency tracking, machine free-times and
  migration accounting.  It is policy-agnostic — a :class:`Scheduler`
  proposes placements and the runtime validates them (planning horizon,
  machine exclusivity, migration penalty charged exactly once per move).
* An :class:`ExecutionBackend` answers one question per accepted task —
  "how long did it take?".  :class:`SimBackend` answers from the
  :class:`WorkerSpec` estimate (the historical wall-clock-free DES,
  behavior preserved exactly).  ``repro_torch.cluster.live.LiveBackend``
  executes the task as a real ``SPBEngine`` train step on the shared
  device and answers with measured seconds, feeding the measurement
  back into the job's ``WorkerSpec`` estimates so the scheduler's next
  placements use real costs.

Fault tolerance threads a :class:`~repro_torch.cluster.faults.FaultPlan`
through the same event loop.  Because the clock is *virtual* in both
backends (the DES advances by estimates, the live pool by measured
durations), one seeded plan drives identical crash/straggler/retry
schedules against either backend:

* a machine **crash** kills the tasks on it, takes the machine out of
  :class:`ClusterState` until its MTTR elapses, and rolls every job with
  worker state resident on it back to its last checkpointed iteration
  (cadence: ``ckpt_every``); the lost work is priced honestly in
  :class:`SimResult` (``goodput``, ``lost_iterations``, ``recovery_s``);
* a transient **task failure** charges the partial attempt and retries;
* a **straggler** stretches task durations on one machine, and — when a
  :class:`~repro_torch.cluster.health.HealthMonitor` +
  :class:`~repro_torch.cluster.health.DegradePolicy` pair is attached — the
  runtime responds by snapping that machine's tasks to a shallower SPB
  depth (the :class:`TaskContext` carries the degraded fraction to the
  backend, which enacts it for real under ``LiveBackend``).

With ``faults=None`` the loop is byte-identical to the pre-fault runtime.

``repro_torch.jigsaw.simulator`` is a shim over this module, as in the
reference.
"""
from __future__ import annotations

import heapq
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .faults import FaultPlan
from .health import DegradePolicy, HealthMonitor


@dataclass
class WorkerSpec:
    """Per-worker cost estimates (seconds / GB).  Under a live backend
    ``duration`` is updated in place from measured step times — the
    scheduler's cost model converges onto reality.  ``frac`` is the
    worker's planned SPB backprop fraction (1.0 = full backprop); the
    degradation path uses it to price shallower-depth recovery steps."""
    duration: float              # one iteration of this worker's task
    memory: float                # peak GB while running
    frac: float = 1.0            # planned backprop fraction (SPB depth)


@dataclass
class JobSpec:
    job_id: int
    arrival: float
    model: str
    model_size_gb: float
    iterations: int
    workers: List[WorkerSpec]

    @property
    def num_workers(self) -> int:
        return len(self.workers)


@dataclass(eq=False)
class Task:
    """eq=False: tasks are identity-keyed.  Two workers of one job can
    have identical field values, and value-equality removal from the ready
    queue would alias them (and cost a linear scan per placement)."""
    job_id: int
    worker_id: int
    iteration: int
    duration: float
    memory: float
    ready_time: float            # prev iteration finished


@dataclass
class Assignment:
    task: Task
    machine: int
    start: float


@dataclass
class ClusterState:
    num_machines: int
    machine_mem_gb: float
    machine_free_at: List[float]
    # worker (job, wid) -> machine it last ran on (affinity / migration)
    last_machine: Dict[Tuple[int, int], int]
    # machines currently crashed (schedulers must not place on these;
    # the runtime rejects such placements regardless)
    down: Set[int] = field(default_factory=set)


@dataclass(frozen=True)
class TaskContext:
    """Fault/degradation context the runtime hands to ``run_task``.

    ``frac`` is the worker's planned backprop fraction, ``degraded_frac``
    what the task should actually run at (== ``frac`` unless the health
    monitor flagged the machine), ``slowdown`` the environment straggle
    factor, and ``time_scale`` the net duration multiplier a DES backend
    should apply (``slowdown`` x the degradation speedup).
    """
    frac: float = 1.0
    degraded_frac: float = 1.0
    slowdown: float = 1.0
    time_scale: float = 1.0

    @property
    def degraded(self) -> bool:
        return self.degraded_frac < self.frac


class TaskFailedError(RuntimeError):
    """A backend exhausted its retry budget for one task.  The runtime
    responds by marking that *job* failed gracefully — other jobs keep
    running — rather than crashing the session.  ``elapsed_s`` is the
    virtual time the doomed attempts occupied the machine."""

    def __init__(self, job_id: int, reason: str, elapsed_s: float = 0.0):
        super().__init__(f"job {job_id}: {reason}")
        self.job_id = job_id
        self.reason = reason
        self.elapsed_s = elapsed_s


class Scheduler:
    """Interface: given ready tasks and cluster state, assign them."""
    name = "base"

    def place(self, tasks: List[Task], state: ClusterState, now: float,
              jobs: Dict[int, JobSpec], gamma: float) -> List[Assignment]:
        raise NotImplementedError


class ExecutionBackend:
    """Executes accepted tasks for the runtime.

    The runtime owns all bookkeeping; a backend only supplies each task's
    duration (and may react to job lifecycle events).  ``run_task`` is
    called exactly once per accepted placement, after the migration
    penalty and horizon checks, in virtual-ready order per job.

    A backend that sets ``concurrent_rounds = True`` (the spatial
    LiveBackend) asks the runtime to execute each scheduling round's
    accepted placements *concurrently across machines*: per-machine task
    chains stay sequential (a machine runs one task at a time) but
    different machines' chains run in parallel threads, so disjoint
    submeshes genuinely overlap wall-clock.  Such a backend's
    ``run_task`` must be thread-safe across jobs.  The concurrent path
    only engages when fault injection and health monitoring are off.
    """
    name = "base"
    concurrent_rounds = False

    def job_arrived(self, job: JobSpec, now: float) -> None:
        """A job entered the system (its iteration-0 tasks spawn next)."""

    def run_task(self, job: JobSpec, task: Task, machine: int,
                 start: float, migrated: bool,
                 ctx: Optional[TaskContext] = None) -> float:
        """Execute ``task``; return its duration in seconds.  ``ctx`` is
        only passed when fault injection / depth degradation is active."""
        raise NotImplementedError

    def job_checkpoint(self, job: JobSpec, iteration: int,
                       now: float) -> None:
        """The runtime's checkpoint cadence fired: persist ``job``'s
        state as of ``iteration`` completed iterations."""

    def job_rollback(self, job: JobSpec, to_iteration: int,
                     now: float) -> None:
        """A fault destroyed ``job``'s in-memory state: restore from the
        snapshot at ``to_iteration`` (0 = the initial state)."""

    def job_failed(self, job: JobSpec, now: float, reason: str) -> None:
        """``job`` was marked failed after a :class:`TaskFailedError`."""

    def job_finished(self, job: JobSpec, now: float) -> None:
        """All of ``job``'s iterations completed."""

    def close(self) -> None:
        """Release backend resources (engine pools etc.)."""


class SimBackend(ExecutionBackend):
    """The DES backend: tasks 'run' for exactly their estimated duration
    (wall-clock-free — this is the historical simulator behavior), scaled
    by the fault context when one is active."""
    name = "sim"

    def run_task(self, job: JobSpec, task: Task, machine: int,
                 start: float, migrated: bool,
                 ctx: Optional[TaskContext] = None) -> float:
        if ctx is not None:
            return task.duration * ctx.time_scale
        return task.duration


@dataclass
class SimResult:
    makespan: float
    jct: Dict[int, float]                  # job -> completion - arrival
    migrations: Dict[int, int]             # job -> total worker migrations
    total_iterations: Dict[int, int]
    machine_busy: float                    # total busy machine-seconds
    util: float                            # busy / available capacity
    #   capacity = makespan * machines - down_s: crashed machines are
    #   excluded from the denominator while down, so fault-heavy runs
    #   don't under-report how well the *surviving* pool was used
    # optional full schedule: (machine, start, end, job, worker, iteration)
    schedule: List[Tuple[int, float, float, int, int, int]] = field(
        default_factory=list)
    # -- fault accounting (defaults keep fault-free results unchanged) ----
    goodput: float = 0.0                   # (busy - wasted) / capacity;
    #                                        == util when nothing failed
    wasted_s: float = 0.0                  # machine-seconds whose output
    #                                        was lost to faults/rollbacks
    lost_iterations: Dict[int, int] = field(default_factory=dict)
    recovery_s: Dict[int, float] = field(default_factory=dict)
    failed_jobs: List[int] = field(default_factory=list)
    crashes: int = 0
    # (job, worker, iteration, machine, t_killed) per fault-killed task
    killed_tasks: List[Tuple[int, int, int, int, float]] = field(
        default_factory=list)
    # (job, worker, iteration) per transient-failure retry
    retried_tasks: List[Tuple[int, int, int]] = field(default_factory=list)
    degraded_steps: int = 0                # tasks run at shallower depth
    down_s: float = 0.0                    # machine-seconds crashed-out
    #                                        (subtracted from capacity)

    @property
    def task_retries(self) -> int:
        return len(self.retried_tasks)

    def migration_fraction(self, job_id: int) -> float:
        it = self.total_iterations[job_id]
        w = max(1, it)
        return self.migrations[job_id] / w


def _down_seconds(plan: FaultPlan, makespan: float,
                  num_machines: int) -> float:
    """Total machine-seconds inside ``[0, makespan]`` during which some
    machine was crashed: per-machine crash intervals, clipped to the
    session window and merged (overlapping crashes don't double-count).
    This is what the util/goodput denominators exclude."""
    by_machine: Dict[int, List[Tuple[float, float]]] = {}
    for c in plan.crashes:
        if not 0 <= c.machine < num_machines:
            continue
        s = min(max(c.at, 0.0), makespan)
        e = min(max(c.repaired_at, 0.0), makespan)
        if e > s:
            by_machine.setdefault(c.machine, []).append((s, e))
    total = 0.0
    for ivs in by_machine.values():
        ivs.sort()
        cur_s, cur_e = ivs[0]
        for s, e in ivs[1:]:
            if s > cur_e:
                total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        total += cur_e - cur_s
    return total


class ClusterRuntime:
    """The shared event loop.  ``gamma``: seconds/GB model-transfer cost.

    ``horizon`` is the paper's scheduling interval T: only assignments
    starting within now+horizon are committed; everything else stays in
    the ready queue and is re-prioritized at the next decision point (this
    is what lets LAS/packing orders actually matter).

    Fault knobs (all default-off; the fault-free path is byte-identical
    to the historical runtime):

    * ``faults`` — a :class:`~repro_torch.cluster.faults.FaultPlan` injected
      into the event loop on the virtual clock.
    * ``ckpt_every`` — checkpoint cadence in iterations; the runtime
      calls ``backend.job_checkpoint`` at each boundary and rolls a
      faulted job back to its last snapshotted iteration (0 when the
      cadence is off, i.e. the job restarts from scratch).
    * ``health`` + ``degrade`` — straggler detection and the SPB-depth
      response: tasks placed on a flagged machine run at a shallower
      backprop fraction (priced into the DES, enacted for real by
      ``LiveBackend``).
    """

    def __init__(self, jobs: List[JobSpec], scheduler: Scheduler,
                 backend: Optional[ExecutionBackend] = None, *,
                 num_machines: int = 45, machine_mem_gb: float = 16.0,
                 gamma: float = 2.0, max_time: float = 10e6,
                 horizon: float = 60.0, record_schedule: bool = False,
                 faults: Optional[FaultPlan] = None, ckpt_every: int = 0,
                 health: Optional[HealthMonitor] = None,
                 degrade: Optional[DegradePolicy] = None,
                 round_quantum: float = 0.0):
        self.jobs = list(jobs)
        self.jobs_by_id = {j.job_id: j for j in self.jobs}
        self.scheduler = scheduler
        self.backend = backend if backend is not None else SimBackend()
        self.num_machines = num_machines
        self.machine_mem_gb = machine_mem_gb
        self.gamma = gamma
        self.max_time = max_time
        self.horizon = horizon
        self.record_schedule = record_schedule
        self.faults = faults
        if ckpt_every < 0:
            raise ValueError(f"ckpt_every must be >= 0, got {ckpt_every}")
        self.ckpt_every = ckpt_every
        self.health = health
        self.degrade = degrade
        if round_quantum < 0:
            raise ValueError(
                f"round_quantum must be >= 0, got {round_quantum}")
        # scheduler-tick width for concurrent backends: events landing
        # within one quantum of the popped event are drained into the same
        # placement round, so near-simultaneous iteration completions on
        # different submeshes keep overlapping instead of degenerating
        # into alternating single-task rounds.  Only consulted when the
        # concurrent path engages; 0.0 still batches equal-time events.
        self.round_quantum = round_quantum
        for j in self.jobs:   # fail fast on unplaceable jobs (would livelock)
            if j.num_workers > num_machines:
                raise ValueError(f"job {j.job_id} needs {j.num_workers} "
                                 f"workers > {num_machines} machines")
            if any(w.memory > machine_mem_gb for w in j.workers):
                raise ValueError(f"job {j.job_id} worker exceeds machine "
                                 f"memory")

    def run(self) -> SimResult:
        """Drive the session to completion and summarize it."""
        jobs_by_id = self.jobs_by_id
        gamma, horizon = self.gamma, self.horizon
        plan, health, degrade = self.faults, self.health, self.degrade
        state = ClusterState(self.num_machines, self.machine_mem_gb,
                             [0.0] * self.num_machines, {})

        # per-job progress
        remaining: Dict[int, int] = {}     # unfinished tasks in current iter
        cur_iter: Dict[int, int] = {j.job_id: 0 for j in self.jobs}
        done_jobs: Dict[int, float] = {}
        migrations = {j.job_id: 0 for j in self.jobs}
        busy = 0.0

        # fault bookkeeping.  ``gen``/``tgen`` make in-flight work
        # invalidatable: a rollback bumps the job's generation, so pending
        # task_done/retry events for its old tasks pop as stale no-ops.
        # Maintained unconditionally (never stale without faults).
        gen: Dict[int, int] = {j.job_id: 0 for j in self.jobs}
        tgen: Dict[int, int] = {}          # id(task) -> spawn generation
        # id(task) -> (task, machine, start, end) for accepted, unfinished
        inflight: Dict[int, Tuple[Task, int, float, float]] = {}
        ckpt_iter: Dict[int, int] = {j.job_id: 0 for j in self.jobs}
        # machine-seconds of *completed* tasks since the job's last
        # snapshot: exactly the work a rollback discards (checkpointed
        # progress is durable; uncommitted progress is what gets wasted)
        ckpt_busy: Dict[int, float] = {j.job_id: 0.0 for j in self.jobs}
        failed: Set[int] = set()
        failed_jobs: List[int] = []
        recovery_pending: Dict[int, Tuple[float, int]] = {}  # t0, target it
        recovery_s: Dict[int, float] = {}
        lost_iterations: Dict[int, int] = {}
        killed_tasks: List[Tuple[int, int, int, int, float]] = []
        retried_tasks: List[Tuple[int, int, int]] = []
        failed_once: Set[Tuple[int, int, int]] = set()
        down_until: Dict[int, float] = {}
        log_idx: Dict[int, int] = {}       # id(task) -> schedule_log index
        wasted = 0.0
        crashes_n = 0

        ready: List[Task] = []
        # event heap: (time, seq, kind, payload)
        events: List[Tuple[float, int, str, object]] = []
        seq = 0
        for j in self.jobs:
            heapq.heappush(events, (j.arrival, seq, "arrival", j.job_id))
            seq += 1
        if plan is not None:
            for c in plan.crashes:
                if 0 <= c.machine < self.num_machines:
                    heapq.heappush(events, (c.at, seq, "crash", c))
                    seq += 1
                    if c.repaired_at < float("inf"):
                        heapq.heappush(events, (c.repaired_at, seq,
                                                "repair", c.machine))
                        seq += 1

        def spawn_iteration(job: JobSpec, it: int, t: float):
            remaining[job.job_id] = job.num_workers
            g = gen[job.job_id]
            for wid, w in enumerate(job.workers):
                task = Task(job.job_id, wid, it, w.duration, w.memory, t)
                tgen[id(task)] = g
                ready.append(task)

        schedule_log: List[Tuple[int, float, float, int, int, int]] = []
        now = 0.0

        def drop_job_tasks(jid: int) -> None:
            """Invalidate a job's outstanding work (rollback / failure):
            its ready tasks vanish, its pending task_done/retry events go
            stale via the generation bump."""
            gen[jid] += 1
            keep = []
            for t in ready:
                if t.job_id == jid:
                    tgen.pop(id(t), None)
                else:
                    keep.append(t)
            ready[:] = keep

        def account_inflight(jid: int, crashed: Optional[int]) -> None:
            """Price a faulted job's accepted-but-unfinished tasks.  Tasks
            on the crashed machine stop dead (unexecuted time refunded,
            executed time wasted, schedule entry truncated); siblings on
            healthy machines hold their reservation to completion but the
            result is discarded (full duration wasted) — conservative, and
            it keeps single-value machine free-times sufficient."""
            nonlocal busy, wasted
            for tid in [tid for tid, rec in inflight.items()
                        if rec[0].job_id == jid]:
                task, machine, start, end = inflight.pop(tid)
                dur = end - start
                if crashed is not None and machine == crashed:
                    executed = min(max(0.0, now - start), dur)
                    busy -= dur - executed
                    wasted += executed
                    i = log_idx.pop(tid, None)
                    if i is not None:
                        if executed <= 0.0:
                            schedule_log[i] = None    # never actually ran
                        else:
                            m, s, _e, j_, w_, it_ = schedule_log[i]
                            schedule_log[i] = (m, s, start + executed,
                                               j_, w_, it_)
                else:
                    wasted += dur
                killed_tasks.append((task.job_id, task.worker_id,
                                     task.iteration, machine, now))

        def rollback(jid: int, crashed: Optional[int]) -> None:
            """Roll ``jid`` back to its last checkpointed iteration after
            worker state on ``crashed`` was lost.  Workers whose affinity
            pointed at the dead machine re-place fresh (they reload from
            the checkpoint, not via model transfer — no migration
            penalty); survivors keep their affinity."""
            nonlocal wasted
            job = jobs_by_id[jid]
            k = ckpt_iter[jid]
            lost_iterations[jid] = (lost_iterations.get(jid, 0)
                                    + max(0, cur_iter[jid] - k))
            wasted += ckpt_busy[jid]     # completed-but-unsnapshotted work
            ckpt_busy[jid] = 0.0
            account_inflight(jid, crashed)
            drop_job_tasks(jid)
            if crashed is not None:
                for wid in range(job.num_workers):
                    if state.last_machine.get((jid, wid)) == crashed:
                        del state.last_machine[(jid, wid)]
            if jid not in recovery_pending:
                recovery_pending[jid] = (now, cur_iter[jid])
            else:      # crashed again mid-recovery: keep the earliest t0
                t0, target = recovery_pending[jid]
                recovery_pending[jid] = (t0, max(target, cur_iter[jid]))
            cur_iter[jid] = k
            spawn_iteration(job, k, now + plan.restore_s)
            self.backend.job_rollback(job, k, now)

        fruitless = 0
        # spatial backends overlap machines inside a round; the concurrent
        # path only engages with faults/health off (their bookkeeping
        # assumes serial commit order)
        conc = (getattr(self.backend, "concurrent_rounds", False)
                and plan is None and health is None)
        # one pool for the whole session: thread spawn is ~ms-scale, which
        # at small step sizes would eat the very overlap the concurrent
        # rounds exist to win (created lazily on the first 2-machine round)
        pool: ThreadPoolExecutor = None
        while events or ready:
            if events:
                now, _, kind, payload = heapq.heappop(events)
                if now > self.max_time:
                    break
                # concurrent rounds act like a scheduler tick: events
                # within one quantum join this round, so simultaneous
                # arrivals / near-simultaneous iteration completions are
                # placed together (and genuinely overlap) instead of each
                # triggering its own single-task round
                batch = [(now, kind, payload)]
                while (conc and events
                       and events[0][0] <= batch[0][0] + self.round_quantum
                       and events[0][0] <= self.max_time):
                    t2, _, k2, p2 = heapq.heappop(events)
                    batch.append((t2, k2, p2))
            else:
                batch = []
            for now, kind, payload in batch:
                if kind == "arrival":
                    job = jobs_by_id[payload]
                    self.backend.job_arrived(job, now)
                    spawn_iteration(job, 0, now)
                elif kind == "task_done":
                    task, machine = payload
                    jid = task.job_id
                    stale = tgen.pop(id(task), -1) != gen[jid]
                    rec = inflight.pop(id(task), None)
                    log_idx.pop(id(task), None)
                    if not stale:
                        if rec is not None:
                            ckpt_busy[jid] += rec[3] - rec[2]
                        remaining[jid] -= 1
                        if remaining[jid] == 0:
                            job = jobs_by_id[jid]
                            nxt = cur_iter[jid] + 1
                            cur_iter[jid] = nxt
                            if jid in recovery_pending:
                                t0, target = recovery_pending[jid]
                                if nxt >= target or nxt >= job.iterations:
                                    recovery_s[jid] = (
                                        recovery_s.get(jid, 0.0)
                                        + (now - t0))
                                    del recovery_pending[jid]
                            if nxt >= job.iterations:
                                done_jobs[jid] = now
                                self.backend.job_finished(job, now)
                            else:
                                if (self.ckpt_every > 0
                                        and nxt % self.ckpt_every == 0):
                                    ckpt_iter[jid] = nxt
                                    ckpt_busy[jid] = 0.0   # now durable
                                    self.backend.job_checkpoint(job, nxt,
                                                                now)
                                spawn_iteration(job, nxt, now)
                elif kind == "retry":
                    task = payload
                    if tgen.get(id(task), -1) == gen[task.job_id]:
                        ready.append(task)   # transient failure: go again
                    else:
                        tgen.pop(id(task), None)    # job rolled back/failed
                elif kind == "crash":
                    crash = payload
                    m = crash.machine
                    crashes_n += 1
                    down_until[m] = max(down_until.get(m, 0.0),
                                        crash.repaired_at)
                    state.down.add(m)
                    state.machine_free_at[m] = down_until[m]
                    # every job with worker state resident on m loses it:
                    # running there now, or parked there since last iter
                    affected = {rec[0].job_id for rec in inflight.values()
                                if rec[1] == m}
                    affected |= {j_ for (j_, _w), mm in
                                 state.last_machine.items() if mm == m}
                    for jid in sorted(affected):
                        if jid in done_jobs or jid in failed:
                            continue
                        rollback(jid, m)
                    for key in [k for k, mm in state.last_machine.items()
                                if mm == m]:
                        del state.last_machine[key]
                elif kind == "repair":
                    m = payload
                    # overlapping crashes: only the last repair revives
                    if now >= down_until.get(m, 0.0):
                        state.down.discard(m)
            # ask the policy to place whatever is ready
            accepted_any = False
            accepted_ids: set = set()
            if ready and conc:
                placed = self.scheduler.place(ready, state, now, jobs_by_id,
                                              gamma)
                # Phase A (serial): prefilter in placement order and group
                # candidates into per-machine chains — the only intra-
                # round dependency is same-machine ordering
                chains: Dict[int, List[Assignment]] = {}
                seen_ids: set = set()
                for a in placed:
                    t = a.task
                    if id(t) in seen_ids:
                        continue        # policy returned the task twice
                    jid = t.job_id
                    if jid in failed:
                        seen_ids.add(id(t))
                        accepted_ids.add(id(t))     # sweep out of ready
                        tgen.pop(id(t), None)
                        continue
                    if a.machine in state.down:
                        continue        # no placements on a dead machine
                    seen_ids.add(id(t))
                    chains.setdefault(a.machine, []).append(a)

                def run_chain(m: int, chain: List[Assignment]) -> list:
                    # shared state is read-only here; all mutation happens
                    # in the serial apply phase below
                    recs = []
                    free_local = state.machine_free_at[m]
                    chain_failed: set = set()
                    for a in chain:
                        t = a.task
                        jid = t.job_id
                        if jid in chain_failed:
                            continue    # swept as failed next round
                        prev = state.last_machine.get((jid, t.worker_id))
                        mig = prev is not None and prev != m
                        start = max(a.start, now, free_local, t.ready_time)
                        if mig:
                            start += gamma * jobs_by_id[jid].model_size_gb
                        if start > now + horizon:
                            continue    # outside the planning interval
                        try:
                            duration = self.backend.run_task(
                                jobs_by_id[jid], t, m, start, mig)
                        except TaskFailedError as e:
                            elapsed = max(0.0, e.elapsed_s)
                            free_local = start + elapsed
                            chain_failed.add(jid)
                            recs.append(("failed", t, start, elapsed, e))
                            continue
                        free_local = start + duration
                        recs.append(("done", t, start, duration, mig))
                    return recs

                order = sorted(chains)
                if len(order) <= 1:     # nothing to overlap
                    results = {m: run_chain(m, chains[m]) for m in order}
                else:
                    if pool is None:
                        pool = ThreadPoolExecutor(
                            max_workers=self.num_machines,
                            thread_name_prefix="round")
                    futs = {m: pool.submit(run_chain, m, chains[m])
                            for m in order}
                    results = {m: futs[m].result() for m in order}

                # Phase C (serial, deterministic machine order): commit
                for m in order:
                    for rec in results[m]:
                        kind, t, start = rec[0], rec[1], rec[2]
                        jid = t.job_id
                        if jid in failed:
                            # a sibling machine's chain failed this job
                            # first; discard the committed-too-late step
                            accepted_ids.add(id(t))
                            tgen.pop(id(t), None)
                            continue
                        if kind == "failed":
                            elapsed, e = rec[3], rec[4]
                            accepted_ids.add(id(t))
                            state.machine_free_at[m] = start + elapsed
                            busy += elapsed
                            wasted += elapsed + ckpt_busy[jid]
                            ckpt_busy[jid] = 0.0
                            failed.add(jid)
                            failed_jobs.append(jid)
                            account_inflight(jid, None)
                            drop_job_tasks(jid)
                            recovery_pending.pop(jid, None)
                            self.backend.job_failed(jobs_by_id[jid], now,
                                                    e.reason)
                            accepted_any = True
                            continue
                        duration, mig = rec[3], rec[4]
                        accepted_ids.add(id(t))
                        if mig:
                            migrations[jid] += 1
                        end = start + duration
                        state.machine_free_at[m] = max(
                            state.machine_free_at[m], end)
                        state.last_machine[(jid, t.worker_id)] = m
                        busy += duration
                        inflight[id(t)] = (t, m, start, end)
                        if self.record_schedule:
                            log_idx[id(t)] = len(schedule_log)
                            schedule_log.append((m, start, end, jid,
                                                 t.worker_id, t.iteration))
                        heapq.heappush(events, (end, seq, "task_done",
                                                (t, m)))
                        seq += 1
                        accepted_any = True
            elif ready:
                placed = self.scheduler.place(ready, state, now, jobs_by_id,
                                              gamma)
                for a in placed:
                    t = a.task
                    if id(t) in accepted_ids:
                        continue        # policy returned the task twice
                    jid = t.job_id
                    if jid in failed:
                        accepted_ids.add(id(t))     # sweep out of ready
                        tgen.pop(id(t), None)
                        continue
                    if a.machine in state.down:
                        continue        # no placements on a dead machine
                    key = (jid, t.worker_id)
                    prev = state.last_machine.get(key)
                    mig = prev is not None and prev != a.machine
                    start = max(a.start, now,
                                state.machine_free_at[a.machine],
                                t.ready_time)
                    if mig:
                        # the one place the penalty is charged (tests pin
                        # "exactly once per move" for every backend)
                        start += gamma * jobs_by_id[jid].model_size_gb
                    if start > now + horizon:
                        continue        # outside the planning interval
                    accepted_ids.add(id(t))
                    if mig:
                        migrations[jid] += 1
                    ctx = None
                    if plan is not None or (health is not None
                                            and degrade is not None):
                        w = jobs_by_id[jid].workers[t.worker_id]
                        slow = (plan.slowdown(a.machine, start)
                                if plan is not None else 1.0)
                        frac = degraded = w.frac
                        tscale = slow
                        if (health is not None and degrade is not None
                                and health.is_straggler(a.machine)):
                            d = degrade.degrade(frac)
                            if d < frac:
                                degraded = d
                                tscale *= degrade.time_scale(frac, d)
                                degrade.applied += 1
                        ctx = TaskContext(frac, degraded, slow, tscale)
                    fkey = (jid, t.worker_id, t.iteration)
                    if (plan is not None and fkey not in failed_once
                            and plan.fails(*fkey)):
                        # transient failure: the first attempt dies partway
                        # through; charge the wasted partial run and retry
                        # from the event loop (exactly once per identity)
                        failed_once.add(fkey)
                        f = plan.failure_for(*fkey)
                        partial = t.duration * ctx.time_scale * f.frac
                        state.machine_free_at[a.machine] = start + partial
                        state.last_machine[key] = a.machine
                        busy += partial
                        wasted += partial
                        retried_tasks.append(fkey)
                        t.ready_time = start + partial
                        if self.record_schedule and partial > 0.0:
                            schedule_log.append((a.machine, start,
                                                 start + partial, jid,
                                                 t.worker_id, t.iteration))
                        heapq.heappush(events, (start + partial, seq,
                                                "retry", t))
                        seq += 1
                        accepted_any = True
                        continue
                    try:
                        if ctx is None:
                            duration = self.backend.run_task(
                                jobs_by_id[jid], t, a.machine, start, mig)
                        else:
                            duration = self.backend.run_task(
                                jobs_by_id[jid], t, a.machine, start, mig,
                                ctx=ctx)
                    except TaskFailedError as e:
                        # retries exhausted: fail the job, keep the pool up
                        elapsed = max(0.0, e.elapsed_s)
                        state.machine_free_at[a.machine] = start + elapsed
                        busy += elapsed
                        # the doomed attempts + every completed-but-never-
                        # checkpointed iteration of the dead job are waste
                        wasted += elapsed + ckpt_busy[jid]
                        ckpt_busy[jid] = 0.0
                        failed.add(jid)
                        failed_jobs.append(jid)
                        account_inflight(jid, None)
                        drop_job_tasks(jid)
                        recovery_pending.pop(jid, None)
                        self.backend.job_failed(jobs_by_id[jid], now,
                                                e.reason)
                        accepted_any = True
                        continue
                    if health is not None and t.duration > 0:
                        health.observe(a.machine, estimate_s=t.duration,
                                       observed_s=duration)
                    end = start + duration
                    state.machine_free_at[a.machine] = end
                    state.last_machine[key] = a.machine
                    busy += duration
                    inflight[id(t)] = (t, a.machine, start, end)
                    if self.record_schedule:
                        log_idx[id(t)] = len(schedule_log)
                        schedule_log.append((a.machine, start, end, jid,
                                             t.worker_id, t.iteration))
                    heapq.heappush(events, (end, seq, "task_done",
                                            (t, a.machine)))
                    seq += 1
                    accepted_any = True
            if accepted_ids:
                # one identity-keyed sweep instead of a value-equality
                # linear scan per placed task (O(n) per round, not O(n^2))
                ready[:] = [t for t in ready if id(t) not in accepted_ids]
            if accepted_any:
                fruitless = 0
            if ready and not accepted_any and not events:
                # nothing commits inside the horizon and no future event
                # will re-trigger scheduling: tick at the next machine-free
                # time
                fruitless += 1
                if fruitless > 1000:
                    break           # livelock guard (unsatisfiable tasks)
                nxt = min(state.machine_free_at)
                heapq.heappush(events, (max(nxt, now + horizon), seq, "tick",
                                        None))
                seq += 1
            if not ready and not events:
                break
        if pool is not None:
            pool.shutdown(wait=False)

        makespan = max(done_jobs.values()) if done_jobs else now
        jct = {jid: done_jobs[jid] - jobs_by_id[jid].arrival
               for jid in done_jobs}
        # capacity excludes crashed-out machine-seconds; with no plan (or
        # no crashes) down_s is exactly 0.0 and the arithmetic is
        # bit-identical to the historical busy / (makespan * machines)
        down_s = (_down_seconds(plan, makespan, self.num_machines)
                  if plan is not None and makespan > 0 else 0.0)
        capacity = makespan * self.num_machines - down_s
        util = busy / capacity if capacity > 0 else 0.0
        goodput = (busy - wasted) / capacity if capacity > 0 else 0.0
        # jobs still mid-recovery when the session ended (e.g. failed, or
        # the horizon cut them off): their window closes at `now`
        for jid, (t0, _target) in recovery_pending.items():
            recovery_s[jid] = recovery_s.get(jid, 0.0) + (now - t0)
        if plan is not None:
            schedule_log = [e for e in schedule_log if e is not None]
        return SimResult(makespan, jct, migrations,
                         {j.job_id: j.iterations for j in self.jobs},
                         busy, util, schedule_log,
                         goodput=goodput, wasted_s=wasted,
                         lost_iterations=lost_iterations,
                         recovery_s=recovery_s, failed_jobs=failed_jobs,
                         crashes=crashes_n, killed_tasks=killed_tasks,
                         retried_tasks=retried_tasks,
                         degraded_steps=(degrade.applied if degrade
                                         else 0),
                         down_s=down_s)
