"""Spatial co-location on the CPU (``launch/mesh.split_devices``,
``make_submeshes``, ``assert_disjoint``, ``SPBEngine(submesh=)`` and
``resize``, ``LiveBackend(submeshes=)``, ``launch/cluster.py --spatial
--round-quantum``), against the reference's (``tests/test_spatial.py``).

On the CPU a submesh is a virtual slot of the one ``cpu`` device, as the
reference's submeshes on the CPU are virtual devices
(``--xla_force_host_platform_device_count``).

* ``split_devices`` on the reference's own cases gives the reference's
  groups, or raises its error.
* ``make_submeshes``' selectors, the remainder to the earlier submeshes,
  ``model_parallel > 1`` raising, and ``"appears in submesh"``.
* An engine that moves between two submeshes and back is bit-equal to one
  that stays, and its losses are the reference's one-device engine's
  (from the reference's initial weights) within rtol 1e-4, the f32
  tolerance of the reduced parity tests.
* Step-cache keys differ by submesh and hit again on a rebuilt one; a
  stored table's path is shared across seeds on one submesh.
* Two spatial ``LiveBackend`` sessions, one with fusion on (concurrent
  rounds) and one with a machine crash and a rollback onto the other
  submesh (serial rounds), under one scripted clock whose readings do not
  depend on how the threads interleave: each task's measured seconds are
  set by the fault hook from its (job, iteration).  Their schedule,
  makespan, completion times, migrations, resizes, restores and steps are
  the reference's, which runs the same sessions on two virtual devices in
  a subprocess started when the module starts.
* The driver: ``--spatial --quiet --json-out`` writes
  ``max_concurrent_tasks`` 2, resizes and step-cache hits, as the
  reference's ``test_spatial_live_session_end_to_end`` asserts.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as j_steps
from repro.engine import SPBEngine as JEngine
from repro.launch.mesh import split_devices as j_split_devices
from repro_torch import bridge
from repro_torch.cluster import ClusterRuntime, FaultPlan
from repro_torch.cluster.live import LiveBackend, make_live_job
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine import FusedEngine, SPBEngine, stack_batches, stepcache
from repro_torch.jigsaw.schedulers import JigsawScheduler
from repro_torch.launch import cluster as cluster_mod
from repro_torch.launch import mesh
from repro_torch.launch.mesh import (Submesh, assert_disjoint, make_submeshes,
                                     split_devices)

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CRASH = "crash:0@0.9+0.5"

FUSED_ITERS = (3, 3, 4, 5)          # jobs 0 and 1 fuse; 2 and 3 alone
ROLLBACK_ITERS = (4, 4)


def jobs(make, spb_cls, train_cls, cfg, iters):
    """One worker a job (either package's ``make_live_job``): a job then
    has at most one task in a round, so the order of its resizes does not
    depend on the threads."""
    return [make(i, arrival=0.0, cfg=cfg, iterations=n, num_workers=1,
                 batch=2, seq=16, est_step_s=0.3, model_size_gb=0.01,
                 tcfg=train_cls(optimizer="adamw", learning_rate=3e-3,
                                num_steps=16, seed=i),
                 spb=spb_cls(mode="temporal", k=2))
            for i, n in enumerate(iters)]


class Clock:
    """A clock a thread; the fault hook, called between an attempt's two
    readings, advances it by the task's scripted seconds."""

    def __init__(self):
        self.local = threading.local()

    def __call__(self):
        return getattr(self.local, "t", 0.0)

    def hook(self, jid, task, attempt):
        self.local.t = self() + 0.2 + 0.1 * ((3 * jid + task.iteration) % 4)


def record(res, b) -> dict:
    return {"schedule": res.schedule, "jct": res.jct,
            "makespan": res.makespan, "migrations": res.migrations,
            "resizes": b.resizes, "restores": b.restores,
            "max_concurrent_tasks": b.max_concurrent_tasks,
            "steps_run": b.steps_run, "fused": b.fused}


# the reference's two sessions on two virtual CPU devices, with this
# module's jobs, clock and record
_REFERENCE = textwrap.dedent("""
    import json, sys, tempfile
    sys.path.insert(0, sys.argv[2])
    from repro.cluster import ClusterRuntime
    from repro.cluster.faults import FaultPlan
    from repro.cluster.live import LiveBackend, make_live_job
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.jigsaw.schedulers import JigsawScheduler
    from repro.launch.mesh import make_submeshes
    from test_torch_submesh import (FUSED_ITERS, ROLLBACK_ITERS, Clock, jobs,
                                    record)

    def session(iters, *, fuse, faults=None, ckpt=None):
        clock = Clock()
        b = LiveBackend(jobs(make_live_job, SPBConfig, TrainConfig,
                             reduced_config("yi-6b"), iters),
                        submeshes=make_submeshes(count=2), fuse=fuse,
                        timer=clock, fault_hook=clock.hook, ckpt_dir=ckpt)
        res = ClusterRuntime(b.specs(), JigsawScheduler(), b,
                             num_machines=2, gamma=0.05, horizon=1e9,
                             record_schedule=True, faults=faults,
                             ckpt_every=1 if ckpt else 0).run()
        b.close()
        return record(res, b)

    out = {"fused": session(FUSED_ITERS, fuse=True)}
    with tempfile.TemporaryDirectory() as d:
        out["rollback"] = session(
            ROLLBACK_ITERS, fuse=False, ckpt=d,
            faults=FaultPlan.parse(sys.argv[1], restore_s=0.25))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Starts the reference's sessions on two virtual CPU devices when the
    module starts; the returned callable waits for them and gives their
    records."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, CRASH, str(Path(__file__).parent)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done = {}

    def result(name):
        if not done:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done[name]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# -- partitioning (pure bookkeeping) -----------------------------------------

SPLIT_CASES = {
    "prefix": ([2, 1, 3], 8),
    "remainder_first": ([2, 2, 1], 5),
    "docstring": ([1, 3], 4),
    "not_enough": ([2, 2], 3),
    "empty": ([], 3),
    "zero": ([1, 0], 3),
}


def _split(fn, sizes, n):
    try:
        return fn(sizes, devices=list(range(n)))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_devices_equals_reference(case):
    """The reference's own cases (``tests/test_spatial.py``): the same
    contiguous, disjoint groups, or the same error."""
    sizes, n = SPLIT_CASES[case]
    ours = _split(split_devices, sizes, n)
    assert ours == _split(j_split_devices, sizes, n)
    if not isinstance(ours, tuple):
        flat = [d for g in ours for d in g]
        assert flat == list(range(len(flat)))
        assert [len(g) for g in ours] == sizes


def test_make_submeshes_selectors_and_sizes():
    (one,) = make_submeshes(count=1, device="cpu")
    assert isinstance(one, Submesh) and one.units == (0,)
    assert one.device == torch.device("cpu") and one.share is None
    assert one.sms is None
    subs = make_submeshes([2, 1], device="cpu")
    assert [s.units for s in subs] == [(0, 1), (2,)]
    assert [s.index for s in subs] == [0, 1]
    with pytest.raises(ValueError, match="exactly one"):
        make_submeshes(sizes=[1], count=1, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        make_submeshes(device="cpu")
    with pytest.raises(ValueError, match="submeshes from"):
        make_submeshes(count=0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_submeshes([3], device="cpu", model_parallel=2)
    with pytest.raises(NotImplementedError, match="data group"):
        make_submeshes([2, 2], device="cpu", model_parallel=2)


def test_make_submeshes_gives_the_remainder_first(monkeypatch):
    """Five units over three submeshes split [2, 2, 1], as the
    reference's devices do; more submeshes than units raises."""
    monkeypatch.setattr(mesh, "device_units",
                        lambda device=None, need=1: list(range(5)))
    subs = make_submeshes(count=3, device="cpu")
    assert [s.units for s in subs] == [(0, 1), (2, 3), (4,)]
    with pytest.raises(ValueError, match="count=6 submeshes from 5"):
        make_submeshes(count=6, device="cpu")


def test_assert_disjoint_catches_a_shared_unit():
    (a,) = make_submeshes(count=1, device="cpu")
    (b,) = make_submeshes(count=1, device="cpu")      # the same unit again
    with pytest.raises(ValueError, match="appears in submesh 0 and 1"):
        assert_disjoint([a, b])
    assert_disjoint(make_submeshes(count=2, device="cpu"))
    # equal placements fingerprint equal; disjoint ones never collide
    assert a.fingerprint() == b.fingerprint()
    c, d = make_submeshes(count=2, device="cpu")
    assert c.fingerprint() != d.fingerprint()


# -- the engine on submeshes -----------------------------------------------

def _reference_params(seed):
    return jax.tree.map(np.asarray, j_steps.init_train_state(
        jax.random.key(seed), j_reduced("yi-6b"), JTrain())["params"])


def _engine(sub, seed=0, k=2, **kw):
    return SPBEngine(reduced_config("yi-6b"),
                     TrainConfig(seed=seed, num_steps=16),
                     SPBConfig(mode="temporal", k=k), submesh=sub, **kw)


def test_resize_round_trip_is_bit_equal_and_matches_reference():
    """The reference's ``_RESIZE_SCRIPT``: one engine moves to submesh 1
    at step 2 and back at step 4, one stays on submesh 0; both start
    from the reference's initial weights.  The moved one's losses are the
    staying one's exactly, and the reference's one-device engine's within
    rtol 1e-4."""
    subs = make_submeshes(count=2, device="cpu")
    cfg = reduced_config("yi-6b")
    init = _reference_params(0)
    moved, stay = _engine(subs[0]), _engine(subs[0])
    for e in (moved, stay):
        e.attach_state(steps_lib.state_from_params(
            bridge.params_from_numpy(init, cfg), e.tcfg))
    ref = JEngine(j_reduced("yi-6b"), JTrain(seed=0, num_steps=16),
                  JSPB(mode="temporal", k=2))
    ref.init_state(jax.random.key(0))
    pipe, jpipe = Pipeline(cfg, 2, 16, seed=0), JPipeline(j_reduced("yi-6b"),
                                                          2, 16, seed=0)
    losses = {"moved": [], "stay": [], "ref": []}
    for step in range(6):
        if step == 2:
            moved.resize(subs[1])
        if step == 4:
            moved.resize(subs[0])
        b = pipe.get_batch(step)
        losses["moved"].append(float(moved.train_step(b, step)["loss"]))
        losses["stay"].append(float(stay.train_step(b, step)["loss"]))
        losses["ref"].append(float(ref.train_step(jpipe.get_batch(step),
                                                  step)["loss"]))
    assert losses["moved"] == losses["stay"]
    np.testing.assert_allclose(losses["moved"], losses["ref"], rtol=1e-4)
    assert moved.resizes == 2 and stay.resizes == 0
    assert moved.submesh is subs[0]
    assert moved.resize(subs[0]) is moved and moved.resizes == 2
    for got, want in zip(moved.state["params"].values(),
                         stay.state["params"].values()):
        for a, b in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert torch.equal(a, b)


def test_fused_engine_resizes_like_a_solo_one():
    subs = make_submeshes(count=2, device="cpu")
    cfg = reduced_config("yi-6b")
    pipes = [Pipeline(cfg, 2, 16, seed=s) for s in (0, 1)]
    engines = [FusedEngine(cfg, TrainConfig(num_steps=16),
                           SPBConfig(mode="temporal", k=2), num_jobs=2,
                           submesh=subs[0]) for _ in range(2)]
    for e in engines:
        e.init_states([0, 1])
    losses = [[], []]
    for step in range(3):
        if step == 1:
            engines[0].resize(subs[1])
        b = stack_batches([p.get_batch(step) for p in pipes])
        for e, out in zip(engines, losses):
            out.append(e.train_step(b, step)["loss"].tolist())
    assert losses[0] == losses[1]
    assert engines[0].resizes == 1 and engines[0].submesh is subs[1]


def test_submesh_and_resize_refusals():
    subs = make_submeshes(count=2, device="cpu")
    cfg, tcfg = reduced_config("yi-6b"), TrainConfig(num_steps=4)
    spb = SPBConfig(mode="temporal", k=2)
    with pytest.raises(ValueError, match="pipeline's ranks"):
        SPBEngine(cfg, tcfg, spb, submesh=subs[0], parallelism="pipeline")
    with pytest.raises(ValueError, match="disagrees"):
        SPBEngine(cfg, tcfg, spb, submesh=subs[0], device="meta")
    pipe = SPBEngine(cfg, tcfg, spb, parallelism="pipeline", device="cpu")
    with pytest.raises(NotImplementedError, match="processes"):
        pipe.resize(subs[1])


def test_step_cache_keys_and_tables_follow_the_submesh(tmp_path):
    """Keys differ by submesh and hit again on a rebuilt one; two engines
    on one submesh share an entry and a stored table's path whatever
    their seeds, and a depth set or a submesh of its own is another
    table."""
    stepcache.GLOBAL.clear()
    subs = make_submeshes(count=2, device="cpu")
    a, b = _engine(subs[0], seed=0), _engine(subs[1], seed=0)
    assert a.step_cache_key(2) != b.step_cache_key(2)
    assert subs[0].fingerprint() in a.step_cache_key(2)
    assert a.step_fn(2) is not b.step_fn(2)
    stats = stepcache.GLOBAL.stats()
    again = make_submeshes(count=2, device="cpu")       # rebuilt, same units
    c = _engine(again[0], seed=7)
    assert c.step_cache_key(2) == a.step_cache_key(2)
    assert c.step_fn(2) is a.step_fn(2)
    assert stepcache.GLOBAL.stats()["entries"] == stats["entries"]
    assert stepcache.GLOBAL.stats()["hits"] > stats["hits"]
    batch = Pipeline(reduced_config("yi-6b"), 2, 16, seed=0).get_batch(0)
    specs = a.batch_specs_like(batch)
    root = str(tmp_path)
    assert a.aot_cache_path(specs, root) == c.aot_cache_path(specs, root)
    assert b.aot_cache_path(specs, root) != a.aot_cache_path(specs, root)
    d = _engine(subs[0], k=4)
    assert d.aot_cache_path(specs, root) != a.aot_cache_path(specs, root)
    whole = SPBEngine(a.cfg, a.tcfg, a.spb, device="cpu")
    assert whole.aot_cache_path(specs, root) != a.aot_cache_path(specs, root)


# -- LiveBackend(submeshes=) against the reference -------------------------

def _session(iters, *, fuse, faults=None, ckpt=None):
    clock = Clock()
    b = LiveBackend(jobs(make_live_job, SPBConfig, TrainConfig,
                         reduced_config("yi-6b"), iters),
                    submeshes=make_submeshes(count=2, device="cpu"),
                    fuse=fuse, timer=clock, fault_hook=clock.hook,
                    ckpt_dir=ckpt)
    assert b.concurrent_rounds
    res = ClusterRuntime(b.specs(), JigsawScheduler(), b, num_machines=2,
                         gamma=0.05, horizon=1e9, record_schedule=True,
                         faults=faults, ckpt_every=1 if ckpt else 0).run()
    summary = b.summary()
    b.close()
    return json.loads(json.dumps(record(res, b))), summary


def test_fused_spatial_session_equals_reference(reference):
    """Fusion on, concurrent rounds: jobs 0 and 1 run as one group beside
    two solo jobs on two submeshes; the record is the reference's."""
    ours, summary = _session(FUSED_ITERS, fuse=True)
    assert ours == reference("fused")
    assert ours["max_concurrent_tasks"] == 2
    assert ours["fused"] == {"0": [0, 1]}
    assert sum(ours["resizes"].values()) >= 1
    assert summary[1]["resizes"] == summary[0]["resizes"] \
        == ours["resizes"]["0"]


def test_rollback_onto_another_submesh_equals_reference(reference,
                                                        tmp_path):
    """Machine 0 dies under job 0: the job restores its last snapshot on
    its current submesh and resizes onto submesh 1 when its next task
    lands there; the record is the reference's."""
    ours, summary = _session(
        ROLLBACK_ITERS, fuse=False, ckpt=str(tmp_path),
        faults=FaultPlan.parse(CRASH, restore_s=0.25))
    assert ours == reference("rollback")
    assert ours["restores"] == {"0": 1} and ours["resizes"]["0"] >= 1
    assert summary[0]["resizes"] == ours["resizes"]["0"]


def test_live_backend_submesh_arguments():
    jobs_ = jobs(make_live_job, SPBConfig, TrainConfig,
                 reduced_config("yi-6b"), (1, 1))
    subs = make_submeshes(count=2, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        LiveBackend(jobs_, submeshes=subs, device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        LiveBackend(jobs_, submeshes=[])
    with pytest.raises(ValueError, match="appears in submesh"):
        LiveBackend(jobs_, submeshes=make_submeshes(count=1, device="cpu")
                    + make_submeshes(count=1, device="cpu"))
    b = LiveBackend(jobs_, submeshes=subs[:1])
    spec = b.specs()[0]
    b.job_arrived(spec, 0.0)
    assert b.engines[0].submesh is subs[0]
    with pytest.raises(ValueError, match="machine 1 has no submesh"):
        b._ensure_submesh(0, 1)
    assert not LiveBackend(jobs_, device="cpu").concurrent_rounds


def test_spatial_driver_session_end_to_end(tmp_path):
    """The reference's ``test_spatial_live_session_end_to_end`` with a
    third job: two jobs of equal measured steps never move on the port's
    CPU (the reference's moved because its first steps compiled at
    different speeds), three on two machines always do."""
    out = tmp_path / "session.json"
    stepcache.GLOBAL.clear()        # the counts of this session alone
    cluster_mod.main(["--device", "cpu", "--jobs", "3", "--machines", "2",
                      "--workers", "2", "--iters", "2", "--arrival", "0.0",
                      "--batch", "2", "--seq", "16", "--spatial", "--quiet",
                      "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["spatial"] is True
    assert len(rec["jct"]) == 3
    assert rec["max_concurrent_tasks"] == 2
    assert rec["stepcache"]["hits"] >= 1
    assert rec["stepcache"]["misses"] < 3 * 2 * 2 * 2
    assert sum(rec["resizes"].values()) >= 1
    for s in rec["summary"].values():
        assert s["steps_run"] == 2 * 2


def test_concurrent_rounds_stress_keeps_each_job_in_order():
    """More machines than cores, a shortened switch interval: every job's
    steps run once each, in order, and the in-flight count never passes
    the machines."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        clock = Clock()
        n = (os.cpu_count() or 2) + 2
        b = LiveBackend(jobs(make_live_job, SPBConfig, TrainConfig,
                             reduced_config("yi-6b"), (2,) * n),
                        submeshes=make_submeshes(count=n, device="cpu"),
                        timer=clock, fault_hook=clock.hook)
        seen, lock = {}, threading.Lock()
        real = b._attempt

        def attempt(job, task, ctx):
            with lock:
                seen.setdefault(task.job_id, []).append(
                    b.steps_run[task.job_id])
            return real(job, task, ctx)

        b._attempt = attempt
        res = ClusterRuntime(b.specs(), JigsawScheduler(), b,
                             num_machines=n, gamma=0.05, horizon=1e9).run()
    finally:
        sys.setswitchinterval(old)
    assert len(res.jct) == n
    assert seen == {j: [0, 1] for j in range(n)}
    assert 1 <= b.max_concurrent_tasks <= n
