"""The port's cluster DES against the reference's: ``ClusterRuntime`` with
``SimBackend`` for each scheduler of ``ALL_SCHEDULERS``, with and without a
seeded ``FaultPlan`` + ``HealthMonitor`` + ``DegradePolicy``, equal field by
field (``==``, no tolerance: the two packages run the same pure-Python
arithmetic in the same order); ``FaultPlan.parse`` refusing the same specs;
the trace generator and the ``simulate`` shim equal to the reference's."""
import dataclasses

import pytest

from repro.cluster import (ClusterRuntime as JRuntime,
                           DegradePolicy as JDegrade, FaultPlan as JPlan,
                           HealthMonitor as JHealth, SimBackend as JSim,
                           fail_keys_for as j_fail_keys)
from repro.jigsaw.costmodel import v100_profiles as j_v100
from repro.jigsaw.schedulers import ALL_SCHEDULERS as J_SCHEDULERS
from repro.jigsaw.simulator import simulate as j_simulate
from repro.jigsaw.trace import generate_trace as j_generate_trace
from repro_torch.cluster import (ClusterRuntime, DegradePolicy, FaultPlan,
                                 HealthMonitor, SimBackend, fail_keys_for)
from repro_torch.jigsaw.costmodel import v100_profiles
from repro_torch.jigsaw.schedulers import ALL_SCHEDULERS
from repro_torch.jigsaw.simulator import simulate
from repro_torch.jigsaw.trace import generate_trace

MACHINES, GAMMA, HORIZON = 8, 2.0, 5.0
# short jobs arriving every second on average: the queue stays full, so
# the schedulers' orders and the horizon matter
TRACE = dict(mean_arrival_s=1.0, min_iters=5, max_iters=20)
FIELDS = ("schedule", "jct", "makespan", "util", "goodput", "migrations")


def _trace(gen, db, seed, spb):
    """A 40-job trace less its jobs wider than the 8 machines (the
    runtime refuses those: ``test_too_wide_a_job_is_refused_alike``)."""
    return [j for j in gen(40, seed=seed, db=db, spb=spb, **TRACE)
            if j.num_workers <= MACHINES]


def _plan(cls, keys_for, jobs, seed):
    """Crashes, stragglers and transient task failures, all from ``seed``,
    over the fault-free session's span."""
    return cls.generate(machines=MACHINES, duration_s=60.0, seed=seed,
                        crash_rate=0.3, mttr_s=5.0, slow_rate=0.3,
                        slow_factor=3.0, slow_duration_s=15.0,
                        fail_keys=keys_for(jobs), fail_prob=0.02,
                        restore_s=0.25)


def _assert_equal(ours, theirs):
    for f in FIELDS:
        assert getattr(ours, f) == getattr(theirs, f), f
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _sessions(scheduler, seed, spb, faults):
    out = []
    for (runtime, backend, sched, gen, db, plan_cls, keys_for, health,
         degrade) in (
            (ClusterRuntime, SimBackend, ALL_SCHEDULERS, generate_trace,
             v100_profiles, FaultPlan, fail_keys_for, HealthMonitor,
             DegradePolicy),
            (JRuntime, JSim, J_SCHEDULERS, j_generate_trace, j_v100, JPlan,
             j_fail_keys, JHealth, JDegrade)):
        jobs = _trace(gen, db(), seed, spb)
        kw = {}
        if faults:
            kw = dict(faults=_plan(plan_cls, keys_for, jobs, seed),
                      ckpt_every=2, health=health(min_samples=2),
                      degrade=degrade())
        rt = runtime(jobs, sched[scheduler](), backend(),
                     num_machines=MACHINES, gamma=GAMMA, horizon=HORIZON,
                     record_schedule=True, **kw)
        out.append((rt.run(), kw))
    return out


@pytest.mark.parametrize("spb", [True, False], ids=["spb", "full"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scheduler", sorted(ALL_SCHEDULERS))
def test_sim_session_equals_reference(scheduler, seed, spb):
    (ours, _), (theirs, _) = _sessions(scheduler, seed, spb, faults=False)
    assert len(ours.jct) == len(_trace(generate_trace, v100_profiles(),
                                       seed, spb))
    _assert_equal(ours, theirs)


@pytest.mark.parametrize("spb", [True, False], ids=["spb", "full"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scheduler", sorted(ALL_SCHEDULERS))
def test_sim_session_with_faults_equals_reference(scheduler, seed, spb):
    (ours, kw), (theirs, jkw) = _sessions(scheduler, seed, spb, faults=True)
    assert dataclasses.asdict(kw["faults"]) == \
        dataclasses.asdict(jkw["faults"])
    assert not kw["faults"].empty
    _assert_equal(ours, theirs)
    assert kw["health"].summary() == jkw["health"].summary()
    assert kw["health"].flagged_total == jkw["health"].flagged_total
    assert kw["degrade"].applied == jkw["degrade"].applied


def test_the_fault_sessions_exercise_every_fault_path():
    """Over the seeds above, the plans crash machines, roll jobs back,
    retry failed tasks and degrade stragglers' depths under jigsaw."""
    seen = dict(crashes=0, lost=0, retries=0, degraded=0)
    for seed in range(4):
        (res, _), _ = _sessions("jigsaw", seed, True, faults=True)
        seen["crashes"] += res.crashes
        seen["lost"] += sum(res.lost_iterations.values())
        seen["retries"] += res.task_retries
        seen["degraded"] += res.degraded_steps
    assert all(seen.values()), seen


@pytest.mark.parametrize("spec", [
    "crash:zzz@1+2", "melt:0@1", "slow:1@abc", "fail:1@2", "crash:1",
    "slow:0@1-2", "fail:a.b@c", "crash:0@x+1"])
def test_fault_plan_parse_rejects_the_same_bad_specs(spec):
    with pytest.raises(ValueError, match="bad fault event") as ours:
        FaultPlan.parse(spec)
    with pytest.raises(ValueError) as theirs:
        JPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", [
    "crash:0@5+3;slow:1@2-20x4;fail:1.0@2", "crash:1@10", "slow:2@0-x2",
    " fail:0.1@3 ; crash:0@1.5+0.5 "])
def test_fault_plan_parse_accepts_the_same_specs(spec):
    assert dataclasses.asdict(FaultPlan.parse(spec, restore_s=0.5)) == \
        dataclasses.asdict(JPlan.parse(spec, restore_s=0.5))


@pytest.mark.parametrize("spb", [True, False], ids=["spb", "full"])
@pytest.mark.parametrize("seed", range(4))
def test_generate_trace_equals_reference(seed, spb):
    ours = generate_trace(40, seed=seed, db=v100_profiles(), spb=spb)
    theirs = j_generate_trace(40, seed=seed, db=j_v100(), spb=spb)
    assert [dataclasses.asdict(j) for j in ours] == \
        [dataclasses.asdict(j) for j in theirs]


def test_too_wide_a_job_is_refused_alike():
    jobs = generate_trace(40, seed=0, db=v100_profiles(), **TRACE)
    jjobs = j_generate_trace(40, seed=0, db=j_v100(), **TRACE)
    assert max(j.num_workers for j in jobs) > MACHINES
    with pytest.raises(ValueError) as ours:
        ClusterRuntime(jobs, ALL_SCHEDULERS["jigsaw"](), SimBackend(),
                       num_machines=MACHINES)
    with pytest.raises(ValueError) as theirs:
        JRuntime(jjobs, J_SCHEDULERS["jigsaw"](), JSim(),
                 num_machines=MACHINES)
    assert str(ours.value) == str(theirs.value)


def test_simulate_shim_equals_reference():
    ours = simulate(_trace(generate_trace, v100_profiles(), 1, True),
                    ALL_SCHEDULERS["jigsaw"](), num_machines=MACHINES,
                    record_schedule=True)
    theirs = j_simulate(_trace(j_generate_trace, j_v100(), 1, True),
                        J_SCHEDULERS["jigsaw"](), num_machines=MACHINES,
                        record_schedule=True)
    _assert_equal(ours, theirs)
