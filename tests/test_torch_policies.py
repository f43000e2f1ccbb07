"""Depth policies and the cost model of the port against the reference's
(``repro.engine.policies``, ``repro.jigsaw.costmodel``) on the same
configs: the mirrors of ``tests/test_engine.py``'s policy tests, the
factory, and a policy that asks for the step's time."""
import time
import warnings

import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB
from repro.configs import reduced_config as j_reduced
from repro.engine import policies as j_pol
from repro.jigsaw import costmodel as j_cost
from repro_torch.config import (SPBConfig, TrainConfig, snap_depth,
                                total_layers)
from repro_torch.configs import make_batch, reduced_config
from repro_torch.core import spb as spb_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.policies import (CostModelPolicy, CyclePolicy,
                                         DepthPolicy, FullBackpropPolicy,
                                         SchedulerHookPolicy, make_policy)
from repro_torch.analysis import roofline
from repro_torch.jigsaw import costmodel

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ARCH = "yi-6b"
TOY = dict(name="toy", fwd_s=1.0, bwd_s=3.0, mem_fwd_gb=1, mem_peak_gb=2,
           model_size_gb=1, grad_gb=1)


def _setup(k=4, **spb_kw):
    cfg = reduced_config(ARCH)
    tcfg = TrainConfig(optimizer="adamw", learning_rate=3e-3, num_steps=20,
                       warmup_steps=2)
    return cfg, tcfg, SPBConfig(mode="temporal", k=k, **spb_kw)


def _jax(k=4, **spb_kw):
    return j_reduced(ARCH), JSPB(mode="temporal", k=k, **spb_kw)


def test_cycle_policy_matches_temporal_schedule_and_the_reference():
    cfg, _, spb = _setup(warmup_steps=3)
    policy = CyclePolicy(cfg, spb)
    want = j_pol.CyclePolicy(*_jax(warmup_steps=3))
    sched = spb_lib.make_schedule(cfg, spb)
    for step in range(3 * spb.k + spb.warmup_steps):
        assert policy.depth_for_step(step) == sched.depth_at(step) == \
            want.depth_for_step(step)
    assert isinstance(policy, DepthPolicy)


def test_scheduler_hook_honors_external_depth():
    """The outside controller's request wins over the fallback cycle and
    sticks; clearing hands control back.  Each request snaps as the
    reference's does."""
    cfg, tcfg, spb = _setup()
    hook = SchedulerHookPolicy(cfg, spb, default=CyclePolicy(cfg, spb))
    want = j_pol.SchedulerHookPolicy(*_jax())
    engine = SPBEngine(cfg, tcfg, spb, policy=hook, device="cpu")
    engine.init_state(0)
    batch = make_batch(cfg, 4, 64, device="cpu")

    snapped = hook.request_depth(1)
    assert snapped == want.request_depth(1)
    engine.train_step(batch, 0)
    assert engine.last_depth == snapped == 1
    engine.train_step(batch, 1)
    assert engine.last_depth == 1               # sticky until replaced

    L = total_layers(cfg)
    for j, k in ((0, 4), (1, 4), (3, 4)):
        expect = snap_depth(cfg, max(1, -(-((j + 1) * L) // k)))
        got = hook.request_fraction((j + 1) / k)
        assert got == expect == want.request_fraction((j + 1) / k)

    hook.clear()
    engine.train_step(batch, 7)
    assert engine.last_depth == spb_lib.make_schedule(cfg, spb).depth_at(7)


def test_hook_requests_full_backprop():
    cfg, _, spb = _setup()
    hook = SchedulerHookPolicy(cfg, spb, default=CyclePolicy(cfg, spb))
    hook.request_depth(None)
    assert hook.depth_for_step(0) is None      # explicit full backprop
    assert SchedulerHookPolicy(cfg, spb).depth_for_step(3) is None


@pytest.mark.parametrize("budget", [0.5, 0.6, 0.75, 1.0])
def test_costmodel_policy_keeps_the_references_depths(budget):
    """time(frac) = fwd + frac * bwd: a tight budget keeps the affordable
    depths plus the deepest; the kept set and the emitted cycle equal the
    reference's."""
    cfg, _, spb = _setup()
    prof = costmodel.ModelProfile(**TOY)
    policy = CostModelPolicy(cfg, spb, prof, time_budget_frac=budget)
    want = j_pol.CostModelPolicy(*_jax(), j_cost.ModelProfile(**TOY),
                                 time_budget_frac=budget)
    assert policy.depths == want.depths
    L = total_layers(cfg)
    for d in policy.depths[:-1]:
        assert prof.task_time(d / L) <= budget * prof.task_time(1.0)
    assert max(policy.depths) == max(spb_lib.snapped_depths(cfg, spb))
    assert [policy.depth_for_step(s) for s in range(10)] == \
        [want.depth_for_step(s) for s in range(10)]


def test_costmodel_policy_refuses_an_empty_budget():
    cfg, _, spb = _setup()
    with pytest.raises(ValueError):
        CostModelPolicy(cfg, spb, costmodel.ModelProfile(**TOY),
                        time_budget_frac=0.0)


def test_make_policy_factory(tmp_path, monkeypatch):
    # no dry-run records: whatever a dry run left in the checkout is not
    # this test's input
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    cfg, _, spb = _setup()
    assert isinstance(make_policy("cycle", cfg, spb), CyclePolicy)
    assert isinstance(make_policy("hook", cfg, spb), SchedulerHookPolicy)
    with pytest.warns(UserWarning, match="resnet50"):
        cm = make_policy("costmodel", cfg, spb, time_budget_frac=0.6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_pol.make_policy("costmodel", *_jax(), time_budget_frac=0.6)
    assert isinstance(cm, CostModelPolicy) and cm.depths == want.depths
    for mode in ("off", "spatial", "temporal-mb"):
        pol = make_policy("cycle", cfg, SPBConfig(mode=mode))
        assert isinstance(pol, FullBackpropPolicy)
        assert pol.depth_for_step(0) is None
    with pytest.raises(ValueError):
        make_policy("nope", cfg, spb)


def test_cost_profiles_equal_the_references(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)   # no dry-run records
    got, want = costmodel.profile_db(), j_cost.profile_db()
    assert set(got) == set(want)
    for name, p in got.items():
        assert vars(p) == vars(want[name])
        for frac in (0.25, 1.0):
            assert p.task_time(frac) == want[name].task_time(frac)
            assert p.task_mem(frac) == want[name].task_mem(frac)
            assert p.grad_bytes(frac) == want[name].grad_bytes(frac)
    for n, k in ((4, None), (8, 4), (3, 2)):
        assert costmodel.spb_worker_fractions(n, k) == \
            j_cost.spb_worker_fractions(n, k)


class _Timed(CyclePolicy):
    needs_step_time = True

    def __init__(self, cfg, spb):
        super().__init__(cfg, spb)
        self.times = []

    def observe(self, step, step_time_s):
        self.times.append(step_time_s)


def test_a_policy_that_needs_step_time_receives_it(monkeypatch):
    """The engine hands a ``needs_step_time`` policy the step's time, no
    longer than the wall time around ``train_step``.  On the CPU there is
    nothing to synchronize, and nothing is."""
    cfg, tcfg, spb = _setup()
    policy = _Timed(cfg, spb)
    assert not CyclePolicy.needs_step_time and policy.needs_step_time
    engine = SPBEngine(cfg, tcfg, spb, policy=policy, device="cpu")
    engine.init_state(0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail(
        "synchronized a CPU step"))
    batch = make_batch(cfg, 2, 32, device="cpu")
    for s in range(2):
        t0 = time.perf_counter()
        engine.train_step(batch, s)
        wall = time.perf_counter() - t0
        assert 0 < policy.times[s] <= wall
    assert np.isfinite(policy.times).all() and len(policy.times) == 2
