"""The port's ``LiveBackend`` on the CPU against the reference's: two
yi-6b-reduced jobs of two workers, two iterations, batch 2 x 16, both
packages driven by the same scripted timer (so the virtual clock is
deterministic) and the port's engines started from the reference's
initial weights; the same schedule, depths and step counts, and each
job's last xent within rtol 1e-4 (the f32 tolerance of the reduced
parity tests).  Then the port alone: the shared runtime invariants, EMA
feedback into later placements, one retry for a transient error, a
graceful job failure when the retries run out, a device fault that
leaves ``run()`` unretried, a rollback that restores the checkpoint
exactly, a restore of another snapshot raising, the submeshes that were
refused before they were ported, and the default device.

Horizontal fusion (``fuse=True``) against the reference's: two
same-shaped yi-6b-reduced jobs fuse into one ``FusedEngine`` beside a
third job of another shape, from the reference's initial weights: the
leaders-only specs with the group's memory scaled, the schedule, each
member's steps, depths and ``fused_with``, last xent at rtol 1e-4; and a
fused group's rollback under a machine crash, with checkpoints (the
stacked state restored bit for bit) and without (the group restarted
from its members' initial states), the same as the reference's."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.cluster import ClusterRuntime as JRuntime
from repro.cluster.live import (LiveBackend as JLiveBackend,
                                make_live_job as j_make_live_job)
from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.dist import steps as j_steps
from repro.jigsaw.schedulers import JigsawScheduler as JJigsaw
from repro_torch import bridge
from repro_torch.cluster import ClusterRuntime, FaultPlan, SimBackend
from repro_torch.cluster.live import LiveBackend, make_live_job
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.fused import FusedEngine
from repro_torch.jigsaw.schedulers import JigsawScheduler
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_submeshes
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

EPS = 1e-9
MACHINES, GAMMA = 2, 0.05
# scripted step seconds: a deeper worker's step is not always the slower
# one, so the EMA reorders what the scheduler sees
DURATIONS = (0.3, 0.1, 0.25, 0.15, 0.2, 0.35, 0.1, 0.3)


def check_invariants(result, jobs, *, num_machines, gamma):
    """The contract every ExecutionBackend must satisfy when driven by
    the ClusterRuntime (``tests/test_cluster_runtime.py``'s checker).
    ``result`` must carry a recorded schedule."""
    # (0) completion: every job finished every iteration
    assert len(result.jct) == len(jobs)
    assert len(result.schedule) == sum(
        j.iterations * j.num_workers for j in jobs)
    # (1) machine exclusivity: intervals on one machine never overlap
    by_machine = {}
    for m, s, e, jid, wid, it in result.schedule:
        assert 0 <= m < num_machines
        by_machine.setdefault(m, []).append((s, e))
    for ivs in by_machine.values():
        ivs.sort()
        for (s1, e1), (s2, e2) in zip(ivs, ivs[1:]):
            assert s2 >= e1 - EPS
    # (2) sync-SGD gating: iter i+1 starts after ALL of iter i finished
    iter_end = {}
    for m, s, e, jid, wid, it in result.schedule:
        iter_end[(jid, it)] = max(iter_end.get((jid, it), 0.0), e)
    for m, s, e, jid, wid, it in result.schedule:
        if it > 0:
            assert s >= iter_end[(jid, it - 1)] - EPS
    # (3) migration accounting: the runtime's count equals the number of
    # machine changes visible in the schedule (per job)
    moves = {j.job_id: 0 for j in jobs}
    last = {}
    ordered = sorted(result.schedule, key=lambda r: (r[3], r[4], r[5]))
    for m, s, e, jid, wid, it in ordered:
        prev = last.get((jid, wid))
        if prev is not None and prev != m:
            moves[jid] += 1
        last[(jid, wid)] = m
    assert moves == result.migrations
    # (4) work conservation: makespan >= busy time / machines
    assert result.makespan >= result.machine_busy / num_machines - 1e-6


class _ScriptedTimer:
    """Deterministic perf_counter stand-in: each (t0, t1) call pair
    measures the next scripted duration."""

    def __init__(self, durations):
        self._durs = iter(durations)
        self._t = 0.0
        self._mid = False

    def __call__(self):
        if self._mid:
            self._t += next(self._durs)
        self._mid = not self._mid
        return self._t


def _reference_init_state(self, seed):
    """The port engine's initial state: the reference's for ``seed``
    (the two packages' initializers draw different numbers)."""
    params = j_steps.init_train_state(jax.random.key(seed),
                                      j_reduced("yi-6b"), JTrain())["params"]
    return self.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                 self.cfg), self.tcfg))


def _jobs(make, spb_cls, train_cls, cfg, *, n=2, workers=2, iterations=2,
          est=0.2, arrival=0.25):
    return [make(i, arrival=arrival * i, cfg=cfg, iterations=iterations,
                 num_workers=workers, batch=2, seq=16, est_step_s=est,
                 model_size_gb=0.01,
                 tcfg=train_cls(optimizer="adamw", learning_rate=3e-3,
                                num_steps=iterations * workers, seed=i),
                 spb=spb_cls(mode="temporal", k=2))
            for i in range(n)]


def _port_jobs(**kw):
    return _jobs(make_live_job, SPBConfig, TrainConfig,
                 reduced_config("yi-6b"), **kw)


def _run(backend, **kw):
    kw = dict(dict(num_machines=MACHINES, gamma=GAMMA, horizon=120.0,
                   record_schedule=True), **kw)
    return ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                          **kw).run()


@pytest.fixture(scope="module")
def parity_sessions():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SPBEngine, "init_state", _reference_init_state)
        ours = LiveBackend(_port_jobs(), device="cpu",
                           timer=_ScriptedTimer(DURATIONS))
        res = _run(ours)
    theirs = JLiveBackend(_jobs(j_make_live_job, JSPB, JTrain,
                                j_reduced("yi-6b")),
                          timer=_ScriptedTimer(DURATIONS))
    jres = JRuntime(theirs.specs(), JJigsaw(), theirs,
                    num_machines=MACHINES, gamma=GAMMA, horizon=120.0,
                    record_schedule=True).run()
    return (res, ours), (jres, theirs)


def test_live_session_equals_reference(parity_sessions):
    (res, ours), (jres, theirs) = parity_sessions
    assert res.schedule == jres.schedule
    for f in ("jct", "makespan", "util", "migrations"):
        assert getattr(res, f) == getattr(jres, f), f
    assert ours.observed_depths == theirs.observed_depths == {0: {2, 4},
                                                              1: {2, 4}}
    assert ours.steps_run == theirs.steps_run == {0: 4, 1: 4}
    assert ours.task_measured == theirs.task_measured
    assert ours.task_estimates == theirs.task_estimates
    assert set(ours.last_xent) == set(theirs.last_xent) == {0, 1}
    for jid, xent in ours.last_xent.items():
        np.testing.assert_allclose(xent, theirs.last_xent[jid], rtol=1e-4)
    check_invariants(res, ours.specs(), num_machines=MACHINES, gamma=GAMMA)
    # measured durations, not estimates, drove the virtual clock
    for m, s, e, jid, wid, it in res.schedule:
        assert e - s == pytest.approx(ours.task_measured[(jid, wid, it)],
                                      rel=1e-6)


def test_live_summary_matches_reference(parity_sessions):
    (_, ours), (_, theirs) = parity_sessions
    mine, ref = ours.summary(), theirs.summary()
    assert set(mine) == set(ref)
    for jid, s in mine.items():
        for key, value in s.items():
            if key == "final_xent":
                np.testing.assert_allclose(value, ref[jid][key], rtol=1e-4)
            else:
                assert value == ref[jid][key], (jid, key)


def test_live_feedback_updates_subsequent_placements():
    """Measured durations EMA into WorkerSpec.duration (after the first
    run at a depth), so the Task estimates the scheduler prices for later
    iterations track reality instead of the seed estimate."""
    est = 50.0          # wildly wrong seed estimate (seconds)
    measured = [2.0, 1.0, 1.0, 1.0]     # iter0 (first run), iters 1-3
    (lj,) = _port_jobs(n=1, workers=1, iterations=4, est=est)
    assert lj.spec.workers[0].duration == pytest.approx(est)
    backend = LiveBackend([lj], device="cpu", ema=0.5,
                          timer=_ScriptedTimer(measured))
    _run(backend, num_machines=1, gamma=0.0, horizon=1e9)
    assert backend.task_estimates[(0, 0, 0)] == pytest.approx(est)
    assert backend.task_estimates[(0, 0, 1)] == pytest.approx(est)
    e2 = 0.5 * est + 0.5 * measured[1]
    assert backend.task_estimates[(0, 0, 2)] == pytest.approx(e2)
    e3 = 0.5 * e2 + 0.5 * measured[2]
    assert backend.task_estimates[(0, 0, 3)] == pytest.approx(e3)
    assert lj.spec.workers[0].duration == pytest.approx(
        0.5 * e3 + 0.5 * measured[3])


def test_a_transient_error_is_retried_once():
    naps = []

    def hook(jid, task, attempt):
        if (jid, task.worker_id, task.iteration, attempt) == (0, 1, 0, 0):
            raise RuntimeError("transient: connection reset")

    backend = LiveBackend(_port_jobs(), device="cpu", fault_hook=hook,
                          sleeper=naps.append, backoff_s=0.01,
                          timer=_ScriptedTimer(itertools.repeat(0.2)))
    res = _run(backend)
    assert backend.retries == {0: 1}
    assert naps == [0.01]
    assert len(res.jct) == 2 and not res.failed_jobs
    assert backend.steps_run == {0: 4, 1: 4}


def test_exhausted_retries_fail_the_job_gracefully():
    naps = []

    def hook(jid, task, attempt):
        if jid == 1:
            raise RuntimeError("transient: rank died")

    backend = LiveBackend(_port_jobs(), device="cpu", fault_hook=hook,
                          max_retries=2, backoff_s=0.01, sleeper=naps.append,
                          timer=_ScriptedTimer(itertools.repeat(0.2)))
    res = _run(backend)
    assert res.failed_jobs == [1] and sorted(res.jct) == [0]
    assert "failed after 3 attempts" in backend.failed[1]
    assert backend.retries == {1: 3}
    assert naps == [0.01, 0.02]         # backoff doubles between attempts
    assert backend.steps_run[0] == 4 and backend.steps_run[1] == 0


@pytest.mark.parametrize("fault", [
    _build.KernelError("flash_dq: CUDA error 700 (an illegal memory "
                       "access was encountered)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
], ids=["kernel", "cuda", "oom"])
def test_a_device_fault_leaves_run_unretried(fault):
    naps = []

    def hook(jid, task, attempt):
        if (jid, task.iteration) == (0, 1):
            raise fault

    backend = LiveBackend(_port_jobs(), device="cpu", fault_hook=hook,
                          sleeper=naps.append,
                          timer=_ScriptedTimer(itertools.repeat(0.2)))
    with pytest.raises(type(fault)) as info:
        _run(backend)
    assert info.value is fault
    assert backend.retries == {} and naps == [] and not backend.failed


class _RecordingBackend(LiveBackend):
    """Keeps a copy of each job's state at every checkpoint and right
    after every rollback."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.snapshots, self.rolled = {}, []

    def _copy(self, jid):
        state = self.engines[jid].state
        return [t.detach().clone() if isinstance(t, torch.Tensor) else t
                for t in tree_leaves(state)]

    def job_arrived(self, job, now):
        super().job_arrived(job, now)
        self.snapshots[(job.job_id, 0)] = self._copy(job.job_id)

    def job_checkpoint(self, job, iteration, now):
        super().job_checkpoint(job, iteration, now)
        self.snapshots[(job.job_id, iteration)] = self._copy(job.job_id)

    def job_rollback(self, job, to_iteration, now):
        super().job_rollback(job, to_iteration, now)
        self.rolled.append((job.job_id, to_iteration,
                            self._copy(job.job_id)))


def test_rollback_restores_the_latest_checkpoint_exactly(tmp_path):
    """Machine 0 dies at t=3.5 (back at 4.5), job 1's iteration-1 task
    fails once: each rolled-back job's state equals, leaf for leaf and
    bit for bit, the snapshot of the iteration it rolled back to; every
    job still runs its logical step count; and the live session's
    schedule is the DES's under the same plan."""
    plan = FaultPlan.parse("crash:0@3.5+1.0;fail:1.0@1", restore_s=0.25)
    kw = dict(horizon=1e9, faults=plan, ckpt_every=2)
    backend = _RecordingBackend(
        _port_jobs(workers=1, iterations=6, est=1.0, arrival=0.0),
        device="cpu", ckpt_dir=str(tmp_path),
        timer=_ScriptedTimer(itertools.repeat(1.0)))
    res = _run(backend, **kw)
    backend.close()
    assert backend.rolled and res.lost_iterations
    assert res.retried_tasks == [(1, 0, 1)] and backend.retries == {}
    for jid, it, state in backend.rolled:
        want = backend.snapshots[(jid, it)]
        assert len(state) == len(want)
        for got, exp in zip(state, want):
            if isinstance(got, torch.Tensor):
                assert got.dtype == exp.dtype and torch.equal(got, exp)
            else:
                assert got == exp
    assert sum(backend.restores.values()) == len(backend.rolled)
    assert backend.steps_run == {0: 6, 1: 6}
    sim = ClusterRuntime([lj.spec for lj in _port_jobs(
        workers=1, iterations=6, est=1.0, arrival=0.0)], JigsawScheduler(),
        SimBackend(), num_machines=MACHINES, gamma=GAMMA,
        record_schedule=True, **kw).run()
    assert res.schedule == sim.schedule
    assert res.killed_tasks == sim.killed_tasks


def test_a_rollback_to_another_snapshot_raises(tmp_path, monkeypatch):
    """A restore that hands back another iteration's snapshot than the
    runtime asked for is a fault, not a rollback."""
    from repro_torch.checkpoint.manager import CheckpointManager
    restore = CheckpointManager.restore

    def off_by_one(self, state_like, step=None):
        state, got = restore(self, state_like, step=step)
        return state, got + 1

    monkeypatch.setattr(CheckpointManager, "restore", off_by_one)
    backend = LiveBackend(
        _port_jobs(workers=1, iterations=6, est=1.0, arrival=0.0),
        device="cpu", ckpt_dir=str(tmp_path),
        timer=_ScriptedTimer(itertools.repeat(1.0)))
    with pytest.raises(RuntimeError, match="restored the snapshot of "
                                           "iteration"):
        _run(backend, horizon=1e9, ckpt_every=2,
             faults=FaultPlan.parse("crash:0@3.5+1.0"))
    backend.close()


@pytest.mark.parametrize("kw", [dict(submeshes=2)], ids=["submeshes"])
def test_what_is_not_ported_raises(kw):
    """What this refused before the port had submeshes now runs: the
    backend over two CPU submeshes asks for concurrent rounds and
    finishes the session (``tests/test_torch_submesh.py`` holds it to
    the reference's)."""
    backend = LiveBackend(_port_jobs(), submeshes=make_submeshes(
        count=kw["submeshes"], device="cpu"),
        timer=_ScriptedTimer(itertools.repeat(0.1)))
    assert backend.concurrent_rounds
    res = _run(backend, horizon=1e9)
    assert len(res.jct) == 2 and backend.max_concurrent_tasks >= 1
    assert all(s["steps_run"] == 4 and "resizes" in s
               for s in backend.summary().values())


def test_aot_cache_loads_or_exports_each_job(tmp_path):
    """``aot_cache=``: as the reference's backend, the first job of a
    config stores its table ("exported"), the next with the same
    scrubbed key loads it ("loaded"), both show in ``summary()["aot"]``,
    and the session's schedule and xent are those of a session without
    the cache."""
    results = {}
    for cache in (None, str(tmp_path)):
        backend = LiveBackend(_port_jobs(), device="cpu", aot_cache=cache,
                              timer=_ScriptedTimer(itertools.repeat(1.0)))
        res = _run(backend, horizon=1e9)
        results[cache] = (res.jct, {j: s["final_xent"]
                                    for j, s in backend.summary().items()})
        if cache:
            assert backend.aot_events == {0: "exported", 1: "loaded"}
            assert [s["aot"] for s in backend.summary().values()] == [
                "exported", "loaded"]
        backend.close()
    assert results[None] == results[str(tmp_path)]


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveBackend(_port_jobs())



# ---------------------------------------------------------------------------
# Horizontal fusion against the reference
# ---------------------------------------------------------------------------

def _reference_params(seed):
    return jax.tree.map(np.asarray, j_steps.init_train_state(
        jax.random.key(seed), j_reduced("yi-6b"), JTrain())["params"])


def _reference_init_states(self, seeds):
    """The port's fused state: the reference's initial params of each
    member's seed, stacked."""
    params = bridge.stacked_params_from_numpy(
        [_reference_params(s) for s in seeds], self.cfg)
    return self.attach_state({"params": params,
                              "opt": optimizers.init_opt_state(params,
                                                               self.tcfg),
                              "step": 0})


def _fused_jobs(make, spb_cls, train_cls, cfg, **kw):
    """Jobs 0 and 1 share one signature (only their seeds differ); job 2
    runs one more iteration, so it stays alone."""
    jobs = _jobs(make, spb_cls, train_cls, cfg, n=2, **kw)
    (extra,) = _jobs(make, spb_cls, train_cls, cfg, n=3, **kw)[2:]
    extra.spec.iterations += 1
    extra.tcfg = dataclasses.replace(extra.tcfg,
                                     num_steps=extra.tcfg.num_steps + 2)
    return jobs + [extra]


def _specs_view(backend):
    return [(s.job_id, [w.memory for w in s.workers])
            for s in backend.specs()]


@pytest.fixture(scope="module")
def fused_sessions():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SPBEngine, "init_state", _reference_init_state)
        mp.setattr(FusedEngine, "init_states", _reference_init_states)
        ours = LiveBackend(_fused_jobs(make_live_job, SPBConfig, TrainConfig,
                                       reduced_config("yi-6b")),
                           device="cpu", fuse=True,
                           timer=_ScriptedTimer(itertools.cycle(DURATIONS)))
        specs = _specs_view(ours)
        res = _run(ours)
    theirs = JLiveBackend(_fused_jobs(j_make_live_job, JSPB, JTrain,
                                      j_reduced("yi-6b")), fuse=True,
                          timer=_ScriptedTimer(itertools.cycle(DURATIONS)))
    jspecs = _specs_view(theirs)
    jres = JRuntime(theirs.specs(), JJigsaw(), theirs,
                    num_machines=MACHINES, gamma=GAMMA, horizon=120.0,
                    record_schedule=True).run()
    return (res, ours, specs), (jres, theirs, jspecs)


def test_fused_session_equals_reference(fused_sessions):
    (res, ours, specs), (jres, theirs, jspecs) = fused_sessions
    assert specs == jspecs
    assert [j for j, _ in specs] == [0, 2]          # leaders only
    assert specs[0][1] == [2 * m for m in specs[1][1]]
    assert ours.fused == theirs.fused == {0: [0, 1]}
    assert isinstance(ours.engines[0], FusedEngine)
    assert not isinstance(ours.engines[2], FusedEngine)
    assert res.schedule == jres.schedule
    for f in ("jct", "makespan", "util", "migrations"):
        assert getattr(res, f) == getattr(jres, f), f
    assert ours.steps_run == theirs.steps_run == {0: 4, 1: 4, 2: 6}
    assert ours.observed_depths == theirs.observed_depths
    assert ours.observed_depths[0] == ours.observed_depths[1] == {2, 4}
    check_invariants(res, ours.specs(), num_machines=MACHINES, gamma=GAMMA)
    mine, ref = ours.summary(), theirs.summary()
    assert set(mine) == set(ref) == {0, 1, 2}
    for jid, s in mine.items():
        for key, value in s.items():
            if key == "final_xent":
                np.testing.assert_allclose(value, ref[jid][key], rtol=1e-4)
            else:
                assert value == ref[jid][key], (jid, key)
    assert mine[0]["fused_with"] == mine[1]["fused_with"] == [0, 1]
    assert mine[2]["fused_with"] is None
    # the two members trained on their own streams
    assert mine[0]["final_xent"] != mine[1]["final_xent"]


@pytest.mark.parametrize("ckpt", [True, False], ids=["ckpt_dir", "no_ckpt"])
def test_fused_rollback_equals_reference(tmp_path, ckpt):
    """Machine 0 dies at t=3.5 (back at 4.5) under a fused group of two
    one-worker jobs: with checkpoints every 2 iterations the stacked state
    rolls back to the snapshot bit for bit, without them to the members'
    initial states; the schedule, the restores and both members' step
    counts are the reference's."""
    plan = FaultPlan.parse("crash:0@3.5+1.0", restore_s=0.25)
    kw = dict(horizon=1e9, faults=plan, ckpt_every=2 if ckpt else 0)
    jobs = dict(n=2, workers=1, iterations=6, est=1.0, arrival=0.0)
    ours = _RecordingBackend(
        _jobs(make_live_job, SPBConfig, TrainConfig,
              reduced_config("yi-6b"), **jobs),
        device="cpu", fuse=True, timer=_ScriptedTimer(itertools.repeat(1.0)),
        ckpt_dir=str(tmp_path / "ours") if ckpt else None)
    res = _run(ours, **kw)
    ours.close()
    theirs = JLiveBackend(
        _jobs(j_make_live_job, JSPB, JTrain, j_reduced("yi-6b"), **jobs),
        fuse=True, timer=_ScriptedTimer(itertools.repeat(1.0)),
        ckpt_dir=str(tmp_path / "ref") if ckpt else None)
    jres = JRuntime(theirs.specs(), JJigsaw(), theirs,
                    num_machines=MACHINES, gamma=GAMMA,
                    record_schedule=True, **kw).run()
    theirs.close()
    assert ours.fused == theirs.fused == {0: [0, 1]}
    assert ours.rolled and res.lost_iterations
    assert res.schedule == jres.schedule
    assert res.lost_iterations == jres.lost_iterations
    assert ours.restores == theirs.restores == {0: len(ours.rolled)}
    assert ours.steps_run == theirs.steps_run == {0: 6, 1: 6}
    for jid, it, state in ours.rolled:
        assert ckpt or it == 0
        for got, exp in zip(state, ours.snapshots[(jid, it)]):
            if isinstance(got, torch.Tensor):
                assert got.dtype == exp.dtype and torch.equal(got, exp)
            else:
                assert got == exp
    assert ours.summary()[1]["restores"] == len(ours.rolled)
