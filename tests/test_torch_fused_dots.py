"""The 'dots' recompute in the fused (vmapped) step on the CPU
(``lm.swept_grads(remat="dots")``, ``lm._DotsTape``,
``FusedEngine(remat="dots")``), f32, J = 2 tenants, k 2, two steps:

  * on yi-6b-reduced and seamless-m4t-medium-reduced under temporal SPB,
    and yi-6b-reduced under temporal-mb, each tenant's losses, grad norms
    and final parameters equal fused 'none''s within 1e-6 of the leaf's
    largest entry (the sweep's tolerance, ``tests/test_torch_remat.py``),
    each tenant's eager ``SPBEngine(remat="dots")`` at 1e-5 (batched
    products round in another order than single ones,
    ``tests/test_torch_fused.py``), and the reference's ``FusedEngine``
    under ``REMAT="dots"`` from bridged weights at 1e-5;
  * a fused 'dots' step reports J times the eager 'dots' step's kept
    product bytes to ``lm.KEPT_SINKS``;
  * a fused 'dots' step calls the kernels' entry points as one eager
    'dots' step does, at J x B rows (yi-6b, mamba2-2.7b and
    recurrentgemma-2b reduced, the kernels on);
  * a replay whose product count, call or shape differs from its record
    raises.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import Pipeline as JPipeline
from repro.engine import FusedEngine as JFusedEngine
from repro.engine import stack_batches as j_stack_batches
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.fused import FusedEngine, stack_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import rglru, rglru_bwd, ssd, ssd_bwd
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

J = 2
SEEDS = [0, 1]
STEPS = 2
B, S = 2, 16
SWEEP_TOL = 1e-6
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [("yi-6b", "temporal"), ("seamless-m4t-medium", "temporal"),
         ("yi-6b", "temporal-mb")]
IDS = ["yi-6b", "seamless", "yi-6b-mb"]


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max(initial=0.0)
                 / max(np.abs(want).max(initial=0.0), 1.0))


def _kept_bytes(fn):
    """``fn()`` and the product bytes it reported to ``lm.KEPT_SINKS``."""
    kept = []
    lm.KEPT_SINKS.append(lambda ts, n: kept.append(n))
    try:
        return fn(), sum(kept)
    finally:
        lm.KEPT_SINKS.pop()


def _pipes(cfg):
    return [Pipeline(cfg, B, S, seed=s) for s in SEEDS]


def _fused_run(arch, mode, remat):
    """Two fused steps of J tenants from ``init_states(SEEDS)``: per job
    [(loss, grad_norm)] a step, the final params, each step's kept
    bytes."""
    cfg = reduced_config(arch)
    eng = FusedEngine(cfg, TrainConfig(num_steps=8), SPBConfig(mode=mode,
                                                               k=2),
                      num_jobs=J, device="cpu", remat=remat,
                      shared_cache=False)
    eng.init_states(SEEDS)
    pipes, hist, kept = _pipes(cfg), [], []
    for step in range(STEPS):
        batch = stack_batches([p.get_batch(step) for p in pipes])
        m, nbytes = _kept_bytes(lambda: eng.train_step(batch, step))
        hist.append(eng.per_job_metrics(m))
        kept.append(nbytes)
    return hist, [t.detach().clone() for t in tree_leaves(
        eng.state["params"])], kept


def _eager_run(arch, mode, j):
    """Tenant j alone: two eager 'dots' steps, the same metrics and
    bytes."""
    cfg = reduced_config(arch)
    eng = SPBEngine(cfg, TrainConfig(num_steps=8), SPBConfig(mode=mode, k=2),
                    device="cpu", remat="dots", shared_cache=False)
    eng.init_state(SEEDS[j])
    pipe, hist, kept = _pipes(cfg)[j], [], []
    for step in range(STEPS):
        batch = pipe.get_batch(step)
        m, nbytes = _kept_bytes(lambda: eng.train_step(batch, step))
        hist.append({k: v.detach() for k, v in m.items()})
        kept.append(nbytes)
    return hist, [t.detach().clone() for t in tree_leaves(
        eng.state["params"])], kept


@pytest.fixture(scope="module")
def runs():
    """Per case, run at its first use: fused 'none', fused 'dots' and each
    tenant's eager 'dots'."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, mode = case
            cache[case] = {
                "none": _fused_run(arch, mode, "none"),
                "dots": _fused_run(arch, mode, "dots"),
                "eager": [_eager_run(arch, mode, j) for j in range(J)]}
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dots_equals_fused_none(case, runs):
    got, want = runs(case)["dots"], runs(case)["none"]
    for s in range(STEPS):
        for j in range(J):
            for k in ("loss", "xent", "grad_norm"):
                assert _rel_err(got[0][s][j][k].numpy(),
                                want[0][s][j][k].numpy()) <= SWEEP_TOL, \
                    (s, j, k)
    for a, b in zip(got[1], want[1]):
        assert _rel_err(a.numpy(), b.numpy()) <= SWEEP_TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dots_equals_each_tenants_eager_dots(case, runs):
    got = runs(case)["dots"]
    for j, (hist, params, _) in enumerate(runs(case)["eager"]):
        for s in range(STEPS):
            for k in ("loss", "xent", "grad_norm"):
                torch.testing.assert_close(got[0][s][j][k], hist[s][k],
                                           **FUSED_TOL)
        for a, b in zip(got[1], params):
            torch.testing.assert_close(a[j], b, **FUSED_TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kept_sinks_see_j_times_the_eager_bytes(case, runs):
    """Every fused step keeps its J jobs' products: J times one eager
    'dots' step's bytes (the tenants' batches have one shape), and none
    under 'none'."""
    fused = runs(case)["dots"][2]
    eager = [run[2] for run in runs(case)["eager"]]
    assert all(n > 0 for n in fused)
    for s in range(STEPS):
        assert eager[0][s] == eager[1][s] > 0
        assert fused[s] == J * eager[0][s]
    assert runs(case)["none"][2] == [0] * STEPS


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_dots_equals_the_reference(case):
    """From the reference's stacked initial params, the same stacked
    batches, both under 'dots': per job loss and xent each step, and the
    final params, at 1e-5."""
    arch, mode = case
    jcfg = j_reduced(arch)
    token = jlm.REMAT.set("dots")
    try:
        ref = JFusedEngine(jcfg, JTrain(seed=0, num_steps=8),
                           JSPB(mode=mode, k=2), num_jobs=J)
        ref.init_states(SEEDS)
        params = bridge.stacked_params_from_numpy(
            jax.tree.map(np.asarray, ref.state["params"]),
            reduced_config(arch))
        tcfg = TrainConfig(seed=0, num_steps=8)
        ours = FusedEngine(reduced_config(arch), tcfg,
                           SPBConfig(mode=mode, k=2), num_jobs=J,
                           device="cpu", remat="dots", shared_cache=False)
        ours.attach_state({"params": params,
                           "opt": optimizers.init_opt_state(params, tcfg),
                           "step": 0})
        pipes = [JPipeline(jcfg, B, S, seed=s) for s in SEEDS]
        for step in range(STEPS):
            batch = j_stack_batches([p.get_batch(step) for p in pipes])
            want = ref.per_job_metrics(ref.train_step(batch, step))
            got = ours.per_job_metrics(ours.train_step(
                {k: torch.from_numpy(np.asarray(v))
                 for k, v in batch.items()}, step))
            assert ours.last_depth == ref.last_depth
            for j in range(J):
                for k in ("loss", "xent"):
                    np.testing.assert_allclose(float(got[j][k]),
                                               float(want[j][k]),
                                               **FUSED_TOL)
        want = {_jax_key(q): np.asarray(v) for q, v in
                jax.tree_util.tree_leaves_with_path(ref.state["params"])}
    finally:
        jlm.REMAT.reset(token)
    got = _flat(ours.state["params"])
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **FUSED_TOL)


def _jax_key(path) -> str:
    return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree.detach().numpy()}


ENTRIES = [(fa, "fwd_kernel_layout"), (fab, "bwd_kernel_layout"),
           (fab, "compute_delta"), (fab, "compute_dq"), (fab, "compute_dkv"),
           (ssd, "ssd_fwd_kernel_layout"), (ssd_bwd, "fwd_res_kernel_layout"),
           (ssd_bwd, "bwd_kernel_layout"), (rglru, "rglru_scan"),
           (rglru_bwd, "bwd_kernel_layout")]


# a live SSD layer's first pass: the eager step's entry, the sweep's
_PRIMAL = {"repro_torch.kernels.ssd_bwd.fwd_res_kernel_layout":
           "repro_torch.kernels.ssd.ssd_fwd_kernel_layout"}


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_a_fused_dots_step_calls_the_kernels_as_an_eager_dots_step(
        arch, monkeypatch):
    """Every depth key: a fused 'dots' step calls the kernels' entry
    points in the order and number of one eager 'dots' step, at J x B
    rows (what ``chip_smoke.expected_launches(..., "dots")`` counts on the
    card for attention and RG-LRU layers), the kernels on (their plain
    versions here).  One difference: the sweep's first pass runs under
    ``no_grad``, so a live SSD layer's forward there is the primal scan
    where the eager first pass, with grad on, runs the scan with
    residuals; the recompute runs the latter in both."""
    log = []
    for module, name in ENTRIES:
        real = getattr(module, name)

        def spy(*args, _real=real, _key=f"{module.__name__}.{name}", **kw):
            log.append((_key, args[0].shape[0]))
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, spy)
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=8), SPBConfig(mode="temporal", k=2)
    batches = _pipes(cfg)
    batches = [p.get_batch(0) for p in batches]
    fused = FusedEngine(cfg, tcfg, spb, num_jobs=J, device="cpu",
                        remat="dots", shared_cache=False)
    fused.init_states(SEEDS)
    solo = SPBEngine(cfg, tcfg, spb, device="cpu", remat="dots",
                     shared_cache=False)
    solo.init_state(0)
    for key in fused.depth_keys():
        log.clear()
        solo.train_step(batches[0], depth=key)
        # the first passes: the SSD scans before the first backward
        # kernel, but the last, which is that layer's recompute
        first_bwd = next((i for i, (name, _) in enumerate(log)
                          if name.endswith("bwd_kernel_layout")
                          or name.endswith("compute_delta")), len(log))
        firsts = [i for i, (name, _) in enumerate(log[:first_bwd])
                  if name in _PRIMAL][:-1]
        want = [(_PRIMAL[name] if i in firsts else name, J * rows)
                for i, (name, rows) in enumerate(log)]
        assert want, key
        log.clear()
        fused.train_step(stack_batches(batches), depth=key)
        assert log == want, key


def _two_products(x, w1, w2):
    return (x @ w1).relu() @ w2


@pytest.mark.parametrize("replay", ["fewer", "more", "shape"])
def test_a_replay_that_differs_from_its_record_raises(replay):
    """A record of two products, replayed by a function that runs one,
    three, or a product of another shape: the replay raises, never
    recomputes in silence."""
    rng = np.random.default_rng(0)
    x, w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((3, 4), (4, 5), (5, 2)))
    kept = []
    with torch.no_grad(), lm._DotsTape(kept):
        _two_products(x, w1, w2)
    assert [tuple(out.shape) for _, out in kept] == [(3, 5), (3, 2)]
    run = {"fewer": lambda w: x @ w,
           "more": lambda w: _two_products(x, w, w2) @ torch.ones(2, 2),
           "shape": lambda w: (x @ w) @ torch.ones(5, 3)}[replay]
    with pytest.raises(RuntimeError, match="dots replay"):
        with lm._DotsTape(kept, replay=True) as tape:
            torch.func.vjp(run, w1)
        tape.finish()


def test_a_replay_returns_the_kept_products_and_their_gradients():
    """The replay under ``vmap`` of ``vjp`` gives the product outputs it
    kept (not recomputed ones) and the products' true cotangents."""
    rng = np.random.default_rng(1)
    x, w1, w2 = (torch.from_numpy(rng.standard_normal((J,) + s).astype(
        np.float32)) for s in ((3, 4), (4, 5), (5, 2)))

    def grads(x, w1, w2):
        kept = []
        with torch.no_grad(), lm._DotsTape(kept):
            _two_products(x, w1, w2)
        # a marker the replay must carry into the output: the kept value
        kept[1] = (kept[1][0], kept[1][1] + 1.0)
        with lm._DotsTape(kept, replay=True) as tape:
            out, pull = torch.func.vjp(_two_products, x, w1, w2)
        tape.finish()
        return out, pull(torch.ones_like(out))

    out, got = torch.func.vmap(grads)(x, w1, w2)
    want_out = torch.func.vmap(_two_products)(x, w1, w2)
    torch.testing.assert_close(out, want_out + 1.0)
    _, pull = torch.func.vjp(torch.func.vmap(_two_products), x, w1, w2)
    want = pull(torch.ones_like(want_out))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
