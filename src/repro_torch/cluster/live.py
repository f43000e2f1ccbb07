"""LiveBackend: the scheduler drives a pool of real SPBEngine sessions on
one device (the counterpart of ``repro/cluster/live.py``).

The same ``Scheduler.place()`` policies that drive the DES decide *which
job iterates next, on which machine slot, at what SPB depth* — and each
accepted task executes as a real ``SPBEngine.train_step`` instead of
advancing a virtual clock.

Mapping (many small jobs time-multiplexed on one shared device):

* one :class:`~repro_torch.engine.engine.SPBEngine` per :class:`JobSpec`
  (own params, optimizer state, data stream), all on one device (``cuda``
  unless the caller passes another);
* worker ``j`` of a ``k``-worker job carries the paper's backprop
  fraction ``(j+1)/k``: its task runs at that suffix depth, requested
  through the job's :class:`~repro_torch.engine.policies.SchedulerHookPolicy`
  right before the step — the jigsaw->execution depth knob;
* machines are virtual exclusivity slots: the runtime's bookkeeping
  (iteration gating, migration penalty, horizon) is identical to the
  DES, but task durations are *measured* wall-clock seconds, read after
  the card has finished the step, and each measurement feeds back into
  the job's ``WorkerSpec.duration`` estimate (EMA) so subsequent
  ``place()`` calls price tasks by observed reality instead of the
  static estimate.

The first execution at a given (job, depth) pays the kernels' build and
the allocator's growth; it is excluded from the feedback EMA (the virtual
clock still charges it — a real session pays it too) so steady-state
estimates are not poisoned.

Not ported: spatial submeshes (several GPUs), horizontal fusion and the
AOT step-table cache; the arguments that ask for them raise
``NotImplementedError``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.cluster.runtime import (ExecutionBackend, JobSpec, Task,
                                         TaskContext, TaskFailedError,
                                         WorkerSpec)
from repro_torch.config import ModelConfig, SPBConfig, TrainConfig
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import device_fault, resolve_device
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.policies import CyclePolicy, SchedulerHookPolicy


@dataclass
class LiveJob:
    """One tenant: the scheduling-facing JobSpec plus its session recipe."""
    spec: JobSpec
    cfg: ModelConfig
    tcfg: TrainConfig
    spb: SPBConfig
    batch: int = 4
    seq: int = 32


def make_live_job(job_id: int, arrival: float, cfg: ModelConfig, *,
                  iterations: int, num_workers: Optional[int] = None,
                  batch: int = 4, seq: int = 32, est_step_s: float = 1.0,
                  est_mem_gb: float = 1.0, model_size_gb: float = 0.01,
                  tcfg: Optional[TrainConfig] = None,
                  spb: Optional[SPBConfig] = None) -> LiveJob:
    """Build a LiveJob whose WorkerSpecs carry the paper's per-worker SPB
    fractions: worker j of k backprops (j+1)/k of the layers, so its
    estimated duration/memory scale like the cost model's
    ``fwd + frac*bwd`` (fwd:bwd ~ 1:2).  Estimates only seed the
    scheduler; the live backend replaces them with measurements."""
    k = num_workers if num_workers is not None else (spb.k if spb else 2)
    spb = spb or SPBConfig(mode="temporal", k=max(2, k))
    tcfg = tcfg or TrainConfig(optimizer="adamw", learning_rate=3e-3,
                               num_steps=iterations * k, seed=job_id)
    workers = []
    for j in range(k):
        frac = (j + 1) / k if k > 1 else 1.0
        workers.append(WorkerSpec(
            duration=est_step_s * (1 / 3 + frac * 2 / 3),
            memory=est_mem_gb * (1 / 3 + frac * 2 / 3),
            frac=frac))
    spec = JobSpec(job_id=job_id, arrival=arrival, model=cfg.name,
                   model_size_gb=model_size_gb, iterations=iterations,
                   workers=workers)
    return LiveJob(spec, cfg, tcfg, spb, batch, seq)


class LiveBackend(ExecutionBackend):
    """Executes placed tasks as real train steps on an SPBEngine pool.

    Every engine lives on ``device`` (``cuda`` unless the caller asks for
    another; without a card the default raises, as
    :func:`~repro_torch.device.resolve_device` does).  A task's measured
    time ends after ``torch.cuda.synchronize``: PyTorch returns before the
    card has run the step, and the EMA must learn the card's time, not
    the host's dispatch time.

    ``ema``: weight of the newest measurement when updating the
    ``WorkerSpec.duration`` estimate.  ``timer`` is injectable for
    deterministic tests.

    Fault tolerance: each accepted task gets ``max_retries`` re-attempts
    with exponential backoff (``backoff_s`` doubling; ``sleeper`` is
    injectable) around the real train step; a step exceeding ``timeout_s``
    counts as a failed attempt.  Exhausting the budget raises
    :class:`~repro_torch.cluster.runtime.TaskFailedError`, which the
    runtime turns into a graceful per-job failure instead of a pool crash.
    A kernel's or the card's own fault
    (:func:`~repro_torch.device.device_fault`) is never retried: it leaves
    ``run_task`` at once, uncounted, and so leaves ``ClusterRuntime.run()``.
    With ``ckpt_dir`` set, the backend snapshots each job's engine state
    via :class:`~repro_torch.checkpoint.manager.CheckpointManager` when the
    runtime's ``ckpt_every`` cadence fires, and ``job_rollback`` restores
    the snapshot onto the engine's device.  ``fault_hook(job_id, task,
    attempt)`` is a test seam: it runs inside each attempt and may raise to
    simulate a step failure.

    ``submeshes=`` (spatial co-location, several GPUs: ROADMAP.md Queue 1 B
    item 11), ``fuse=True`` (horizontal fusion: item 13) and
    ``aot_cache=`` (item 9) are not ported and raise
    ``NotImplementedError``.
    """
    name = "live"

    def __init__(self, jobs: List[LiveJob], *, device=None, submeshes=None,
                 fuse: bool = False, ema: float = 0.5,
                 aot_cache: Optional[str] = None, verbose: bool = False,
                 timer: Callable[[], float] = time.perf_counter,
                 ckpt_dir: Optional[str] = None, max_retries: int = 2,
                 backoff_s: float = 0.05, timeout_s: Optional[float] = None,
                 sleeper: Callable[[float], None] = time.sleep,
                 fault_hook: Optional[Callable[[int, Task, int],
                                               None]] = None):
        if submeshes is not None:
            raise NotImplementedError(
                "spatial submeshes need several GPUs: multi-GPU is "
                "ROADMAP.md Queue 1 B item 11")
        if fuse:
            raise NotImplementedError(
                "horizontal fusion (engine/fused.py) needs a vmap rule on "
                "every kernel's autograd.Function: ROADMAP.md Queue 1 B "
                "item 13")
        if aot_cache is not None:
            raise NotImplementedError(
                "the AOT step-table cache is ROADMAP.md Queue 1 B item 9")
        if not 0.0 < ema <= 1.0:
            raise ValueError(f"ema must be in (0, 1], got {ema}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.jobs: Dict[int, LiveJob] = {lj.spec.job_id: lj for lj in jobs}
        if len(self.jobs) != len(jobs):
            raise ValueError("duplicate job_id in LiveJob list")
        self.device = resolve_device(device)
        self.ema = ema
        self.verbose = verbose
        self.timer = timer
        self.ckpt_dir = ckpt_dir
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.sleeper = sleeper
        self.fault_hook = fault_hook
        self.ckpt_mgrs: Dict[int, CheckpointManager] = {}
        # (job, iteration) -> steps_run at snapshot time (rollback rewind)
        self._ckpt_steps: Dict[Tuple[int, int], int] = {}
        self.restores: Dict[int, int] = {}
        self.retries: Dict[int, int] = {}
        self.degraded_steps: Dict[int, int] = {}
        self.failed: Dict[int, str] = {}
        self.engines: Dict[int, SPBEngine] = {}
        self.hooks: Dict[int, SchedulerHookPolicy] = {}
        self._pipes: Dict[int, Pipeline] = {}
        self._warmed: set = set()                  # (job_id, depth_key)
        self.steps_run: Dict[int, int] = {}
        self.observed_depths: Dict[int, set] = {}
        self.last_xent: Dict[int, float] = {}
        # (job, worker, iteration) -> the estimate the scheduler saw /
        # the measured wall-clock — the feedback loop's paper trail
        self.task_estimates: Dict[Tuple[int, int, int], float] = {}
        self.task_measured: Dict[Tuple[int, int, int], float] = {}
        # the high-water mark of overlapping tasks: the runtime calls
        # run_task from one thread (concurrent_rounds is False), so 1
        self._active = 0
        self.max_concurrent_tasks = 0

    # -- runtime hooks -----------------------------------------------------

    def specs(self) -> List[JobSpec]:
        """The scheduling-facing JobSpecs (hand these to ClusterRuntime)."""
        return [lj.spec for lj in self.jobs.values()]

    def job_arrived(self, job: JobSpec, now: float) -> None:
        jid = job.job_id
        lj = self.jobs[jid]
        hook = SchedulerHookPolicy(lj.cfg, lj.spb,
                                   default=CyclePolicy(lj.cfg, lj.spb))
        engine = SPBEngine(lj.cfg, lj.tcfg, lj.spb, policy=hook,
                           device=self.device)
        engine.init_state(lj.tcfg.seed)
        self.engines[jid] = engine
        self.hooks[jid] = hook
        self.steps_run[jid] = 0
        self.observed_depths[jid] = set()
        if self.ckpt_dir:
            # iteration-0 snapshot: a crash before the first cadence tick
            # still has something to roll back to
            mgr = CheckpointManager(
                os.path.join(self.ckpt_dir, f"job_{jid}"), keep=3)
            mgr.save(engine.state, 0)
            self.ckpt_mgrs[jid] = mgr
            self._ckpt_steps[(jid, 0)] = 0
        if self.verbose:
            print(f"[live] job={jid} model={lj.cfg.name} "
                  f"workers={job.num_workers} arrived t={now:.2f}s "
                  f"device={self.device}", flush=True)

    def run_task(self, job: JobSpec, task: Task, machine: int,
                 start: float, migrated: bool,
                 ctx: Optional[TaskContext] = None) -> float:
        jid = task.job_id
        engine, hook = self.engines[jid], self.hooks[jid]
        self.task_estimates[(jid, task.worker_id, task.iteration)] = \
            task.duration
        # the scheduler's depth decision for this worker-task, enacted —
        # shallower when the health monitor degraded this machine
        frac = (task.worker_id + 1) / job.num_workers
        if ctx is not None and ctx.degraded_frac < frac:
            frac = ctx.degraded_frac
            self.degraded_steps[jid] = self.degraded_steps.get(jid, 0) + 1
        hook.request_fraction(frac)
        self._active += 1
        self.max_concurrent_tasks = max(self.max_concurrent_tasks,
                                        self._active)
        try:
            measured, metrics = self._attempt(job, task, ctx)
        finally:
            self._active -= 1
        self.steps_run[jid] += 1
        self.observed_depths[jid].add(engine.last_depth)
        self.last_xent[jid] = float(metrics["xent"])
        self.task_measured[(jid, task.worker_id, task.iteration)] = measured
        warm_key = (jid, engine.last_depth)
        if warm_key in self._warmed:
            # feedback: the measurement displaces the WorkerSpec estimate,
            # so tasks spawned for later iterations carry real costs into
            # Scheduler.place()
            w = job.workers[task.worker_id]
            w.duration = (1 - self.ema) * w.duration + self.ema * measured
        else:
            self._warmed.add(warm_key)      # the first run at this depth
            #                                 may pay the kernels' build and
            #                                 the allocator's growth; don't
            #                                 poison the EMA
        if self.verbose:
            print(f"[live] t={start:8.2f}s machine={machine} job={jid} "
                  f"worker={task.worker_id} iter={task.iteration} "
                  f"depth={engine.last_depth!s:>4} "
                  f"xent={self.last_xent[jid]:.4f} "
                  f"{measured*1e3:7.1f}ms{' MIG' if migrated else ''}",
                  flush=True)
        return measured

    def _attempt(self, job: JobSpec, task: Task,
                 ctx: Optional[TaskContext]) -> Tuple[float, dict]:
        """One task = up to ``1 + max_retries`` real step attempts with
        exponential backoff.  Returns (virtual duration, metrics); raises
        :class:`TaskFailedError` when the budget is exhausted, and a
        device fault at once."""
        jid = task.job_id
        engine = self.engines[jid]
        step = self.steps_run[jid]
        attempts = self.max_retries + 1
        delay = self.backoff_s
        spent = 0.0
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            batch = self._stacked_batch(jid, step)
            t0 = self.timer()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(jid, task, attempt)
                metrics = engine.train_step(batch, step)
                if engine.device.type == "cuda":
                    # the host returns before the card runs the step: the
                    # measurement ends where the step ends on the card
                    torch.cuda.synchronize(engine.device)
            except Exception as e:
                if device_fault(e):
                    raise           # a retry would only hide it
                spent += self.timer() - t0
                last_err = e
                self.retries[jid] = self.retries.get(jid, 0) + 1
                if self.verbose:
                    print(f"[live] job={jid} worker={task.worker_id} "
                          f"iter={task.iteration} attempt {attempt + 1}/"
                          f"{attempts} failed: {e!r}", flush=True)
                if attempt + 1 < attempts:
                    self.sleeper(delay)
                    delay *= 2.0
                continue
            measured = self.timer() - t0
            if ctx is not None and ctx.slowdown != 1.0:
                measured *= ctx.slowdown    # injected straggler: inflate
                #                             the virtual clock + feedback
            spent += measured
            if self.timeout_s is not None and measured > self.timeout_s:
                last_err = TimeoutError(
                    f"step took {measured:.3f}s > timeout_s="
                    f"{self.timeout_s}")
                self.retries[jid] = self.retries.get(jid, 0) + 1
                if attempt + 1 < attempts:
                    self.sleeper(delay)
                    delay *= 2.0
                continue
            return measured, metrics
        raise TaskFailedError(
            jid, f"task (worker {task.worker_id}, iter {task.iteration}) "
                 f"failed after {attempts} attempts: {last_err!r}",
            elapsed_s=spent)

    # -- checkpoint / recovery hooks ---------------------------------------

    def job_checkpoint(self, job: JobSpec, iteration: int,
                       now: float) -> None:
        mgr = self.ckpt_mgrs.get(job.job_id)
        if mgr is None:
            return
        mgr.save(self.engines[job.job_id].state, iteration)
        self._ckpt_steps[(job.job_id, iteration)] = \
            self.steps_run[job.job_id]
        if self.verbose:
            print(f"[live] job={job.job_id} checkpoint iter={iteration} "
                  f"t={now:.2f}s", flush=True)

    def job_rollback(self, job: JobSpec, to_iteration: int,
                     now: float) -> None:
        jid = job.job_id
        engine = self.engines[jid]
        mgr = self.ckpt_mgrs.get(jid)
        if mgr is not None:
            mgr.wait()      # snapshot must be durable (or raise) first
            state, step = mgr.restore(engine.state, step=to_iteration)
            if step != to_iteration:
                raise RuntimeError(f"job {jid}: restored the snapshot of "
                                   f"iteration {step}, not {to_iteration}")
            engine.state = None     # free the lost state before the copy
            engine.attach_state(state)
        else:
            engine.state = None
            engine.init_state(self.jobs[jid].tcfg.seed)
        self.steps_run[jid] = self._ckpt_steps.get((jid, to_iteration), 0)
        self.restores[jid] = self.restores.get(jid, 0) + 1
        if self.verbose:
            print(f"[live] job={jid} restored from checkpoint "
                  f"iter={to_iteration} t={now:.2f}s", flush=True)

    def job_failed(self, job: JobSpec, now: float, reason: str) -> None:
        self.failed[job.job_id] = reason
        if self.verbose:
            print(f"[live] job={job.job_id} FAILED t={now:.2f}s: {reason}",
                  flush=True)

    def job_finished(self, job: JobSpec, now: float) -> None:
        if self.verbose:
            jid = job.job_id
            print(f"[live] job={jid} done t={now:.2f}s "
                  f"steps={self.steps_run[jid]} "
                  f"depths={sorted(self.observed_depths[jid], key=str)}",
                  flush=True)

    def close(self) -> None:
        for mgr in self.ckpt_mgrs.values():
            mgr.wait()      # surface any failed async snapshot writes
        self.engines.clear()
        self.hooks.clear()
        self._pipes.clear()

    # -- reporting ---------------------------------------------------------

    def _pipe(self, jid: int) -> Pipeline:
        if jid not in self._pipes:
            lj = self.jobs[jid]
            self._pipes[jid] = Pipeline(lj.cfg, lj.batch, lj.seq,
                                        seed=lj.tcfg.seed)
        return self._pipes[jid]

    def _stacked_batch(self, jid: int, step: int):
        """The batch one scheduled task of ``jid`` consumes: the job's own
        seeded pipeline output for ``step``."""
        return self._pipe(jid).get_batch(step)

    def summary(self) -> Dict[int, dict]:
        """Per job: the reference's summary less its fusion, resize and
        AOT entries, which this backend does not have."""
        out = {}
        for jid, lj in self.jobs.items():
            meas = [v for (j, _, _), v in self.task_measured.items()
                    if j == jid]
            out[jid] = {
                "model": lj.cfg.name,
                "workers": lj.spec.num_workers,
                "iterations": lj.spec.iterations,
                "steps_run": self.steps_run.get(jid, 0),
                "depths": sorted(self.observed_depths.get(jid, ()),
                                 key=lambda d: (d is None, d)),
                "final_xent": self.last_xent.get(jid),
                "mean_step_ms": (sum(meas) / len(meas) * 1e3 if meas
                                 else None),
                "retries": self.retries.get(jid, 0),
                "restores": self.restores.get(jid, 0),
                "degraded_steps": self.degraded_steps.get(jid, 0),
                "failed": self.failed.get(jid),
            }
        return out
