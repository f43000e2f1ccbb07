"""Scheduling policies: JIGSAW (iteration-level RT-space packing, paper §3)
and the gang-scheduling baselines it is evaluated against (§4.2):
Tiresias-like (Least Attained Service), Gandiva-like (packing), FIFO
(the counterpart of ``repro/jigsaw/schedulers.py``, the same code;
``tests/test_torch_cluster_sim.py`` holds their sessions equal to the
reference's).

Baselines gang-schedule: all workers of a job start an iteration together
and stay pinned to their machines (their APIs assume symmetric workers, so
they cannot exploit SPB's variable per-worker work — the paper's point).
"""
from __future__ import annotations

from bisect import insort
from collections import defaultdict
from typing import Dict, List, Tuple

from repro_torch.jigsaw.simulator import (Assignment, ClusterState, JobSpec,
                                    Scheduler, Task)


class JigsawScheduler(Scheduler):
    """Iteration-level placement into the (resource x time) space.

    Priority: normalized (memory x duration) product, largest first
    (multi-resource packing a la Tetris/Graphene).  Placement: the machine
    where the task can *start earliest*, accounting for the
    gamma*model_size migration penalty when the worker last ran elsewhere —
    which naturally yields machine affinity (paper §3.2).

    The priority order is maintained *incrementally* across ``place()``
    calls (the ROADMAP >10k-task note): a task's ``duration * memory``
    product never changes while it waits, and the per-call normalization
    constants ``1/(maxd*maxm)`` scale every key equally, so the induced
    order is static.  New ready tasks are insorted once on first sight;
    tasks that left the ready queue are lazily skipped and periodically
    compacted — instead of a full re-sort (with Python-level key lambdas)
    of the whole ready queue every scheduling round.  Ties break by
    insertion sequence, which equals ready-queue order (the runtime only
    appends and order-preservingly filters) — the old stable sort's order
    for identical tasks.  Placement output is byte-identical on the
    repo's traces and fig4 benchmark workloads
    (the reference's tests pin this against a re-sort); the
    one divergence class is *distinct* tasks whose exact
    ``duration*memory`` products tie: the old per-call normalized key
    could separate them by last-ulp float noise, whereas this index
    breaks the tie deterministically by arrival order.
    """
    name = "jigsaw"

    def __init__(self):
        self._seq = 0
        self._known: set = set()            # id(task) of indexed tasks
        self._order: List[tuple] = []       # sorted (-dur*mem, seq, task)

    def place(self, tasks: List[Task], state: ClusterState, now: float,
              jobs: Dict[int, JobSpec], gamma: float) -> List[Assignment]:
        live = set(map(id, tasks))
        known = self._known
        for t in tasks:
            if id(t) not in known:
                known.add(id(t))
                insort(self._order, (-(t.duration * t.memory),
                                     self._seq, t))
                self._seq += 1
        out = []
        free = list(state.machine_free_at)
        mem_cap = state.machine_mem_gb
        n_mach = state.num_machines
        down = state.down               # crashed machines: never place
        stale = 0
        for _prio, _seq, t in self._order:
            if id(t) not in live:
                stale += 1              # departed; dropped at compaction
                continue
            if t.memory > mem_cap:
                continue    # memory-infeasible on every machine this round
            prev = state.last_machine.get((t.job_id, t.worker_id))
            penalty = gamma * jobs[t.job_id].model_size_gb
            floor = t.ready_time if t.ready_time > now else now
            best_m, best_start = None, float("inf")
            for m in range(n_mach):
                if m in down:
                    continue
                start = free[m] if free[m] > floor else floor
                if prev is not None and prev != m:
                    start += penalty
                if start < best_start - 1e-12:
                    best_start, best_m = start, m
            if best_m is None:
                continue
            out.append(Assignment(t, best_m, best_start))
            free[best_m] = best_start + t.duration
        if stale * 2 > len(self._order):
            self._order = [e for e in self._order if id(e[2]) in live]
            self._known = set(map(id, (e[2] for e in self._order)))
        return out


class _GangScheduler(Scheduler):
    """Common machinery: whole-job gang placement with pinned workers.

    A job is admitted when enough machines are simultaneously free; its
    workers stay pinned (no migration).  Subclasses define the admission
    key.  Workers all take the *maximum* worker duration per iteration
    (gang barrier — idle bubbles instead of SPB exploitation, Fig 2b).

    Like :class:`JigsawScheduler`, the admission order is maintained
    *incrementally*: each job's priority key is insorted once and only
    re-insorted when it actually changes (FIFO/Gandiva keys are static;
    Tiresias' attained service changes only for jobs placed last round),
    with inactive entries (superseded keys, finished or mid-iteration
    jobs) skipped lazily and compacted away once they dominate — instead
    of re-sorting every ready job id with a Python key lambda each
    ``place()`` call.  Jobs whose keys compare equal keep the historical
    stable-sort order (current ready-queue order), so placements are
    byte-identical to the former full re-sort — pinned by the
    reference's tests on the repo traces and the fig4 benchmark
    workload.
    """
    name = "gang"

    def _key(self, jid: int, jobs: Dict[int, JobSpec]):
        """Admission priority (smaller = earlier); must match what the
        historical ``sorted(job_ids, key=...)`` used."""
        raise NotImplementedError

    def __init__(self):
        self.pinned: Dict[Tuple[int, int], int] = {}
        self.attained: Dict[int, float] = defaultdict(float)
        self._seq = 0
        self._index: List[tuple] = []           # sorted (key, seq, jid)
        self._cur: Dict[int, tuple] = {}        # jid -> live (key, seq)

    def _note(self, jid: int, jobs: Dict[int, JobSpec]) -> None:
        key = self._key(jid, jobs)
        cur = self._cur.get(jid)
        if cur is not None and cur[0] == key:
            return                              # key unchanged: keep entry
        entry = (key, self._seq, jid)
        self._seq += 1
        insort(self._index, entry)
        self._cur[jid] = (key, entry[1])

    def _order(self, job_ids: List[int], jobs: Dict[int, JobSpec],
               state: ClusterState, now: float) -> List[int]:
        for jid in job_ids:
            self._note(jid, jobs)
        live = set(job_ids)
        pos = {jid: i for i, jid in enumerate(job_ids)}
        out: List[int] = []
        run: List[int] = []
        run_key: object = object()
        inactive = 0            # superseded keys + finished/busy jobs
        for key, seq, jid in self._index:
            if self._cur.get(jid) != (key, seq) or jid not in live:
                inactive += 1                   # lazily skipped
                continue
            if key != run_key:
                run.sort(key=pos.__getitem__)
                out.extend(run)
                run, run_key = [jid], key
            else:
                run.append(jid)                 # tie: current-queue order
        run.sort(key=pos.__getitem__)
        out.extend(run)
        if inactive * 2 > len(self._index):
            # keep only this round's live entries; evicted jobs (finished
            # forever, or mid-iteration and coming back) drop out of _cur
            # too, so returning ones simply re-insort.  A fresh seq is
            # placement-neutral: equal-key output order is re-derived
            # from the current queue position every call.
            self._index = [e for e in self._index
                           if self._cur.get(e[2]) == (e[0], e[1])
                           and e[2] in live]
            self._cur = {jid: (key, seq) for key, seq, jid in self._index}
        return out

    def place(self, tasks: List[Task], state: ClusterState, now: float,
              jobs: Dict[int, JobSpec], gamma: float) -> List[Assignment]:
        by_job: Dict[int, List[Task]] = defaultdict(list)
        for t in tasks:
            by_job[t.job_id].append(t)
        out = []
        free = list(state.machine_free_at)
        for jid in self._order(list(by_job), jobs, state, now):
            jtasks = sorted(by_job[jid], key=lambda t: t.worker_id)
            job = jobs[jid]
            started = all((jid, t.worker_id) in state.last_machine
                          for t in jtasks)
            if started:   # workers stay pinned once running (no migration)
                machines = [state.last_machine[(jid, t.worker_id)]
                            for t in jtasks]
            else:
                order = sorted((m for m in range(state.num_machines)
                                if m not in state.down),
                               key=self._machine_key(free))
                if len(order) < len(jtasks):
                    continue
                machines = order[:len(jtasks)]
            start = max([free[m] for m in machines]
                        + [now] + [t.ready_time for t in jtasks])
            gang_dur = max(t.duration for t in jtasks)
            for t, m in zip(jtasks, machines):
                out.append(Assignment(t, m, start))
                # gang barrier: machine is held for the slowest worker
                free[m] = start + gang_dur
            self.attained[jid] += gang_dur * len(jtasks)
        return out

    def _machine_key(self, free):
        return lambda m: free[m]


class TiresiasScheduler(_GangScheduler):
    """Least Attained Service ordering (Tiresias, NSDI'19)."""
    name = "tiresias"

    def _key(self, jid, jobs):
        return self.attained[jid]


class GandivaScheduler(_GangScheduler):
    """Packing-oriented gang scheduler (Gandiva, OSDI'18, simplified):
    admits small jobs first so they pack into gaps, machines chosen by
    earliest availability."""
    name = "gandiva"

    def _key(self, jid, jobs):
        # favor small jobs first to pack tightly
        return (jobs[jid].num_workers, jobs[jid].arrival)


class FifoScheduler(_GangScheduler):
    name = "fifo"

    def _key(self, jid, jobs):
        return jobs[jid].arrival


ALL_SCHEDULERS = {
    "jigsaw": JigsawScheduler,
    "tiresias": TiresiasScheduler,
    "gandiva": GandivaScheduler,
    "fifo": FifoScheduler,
}
