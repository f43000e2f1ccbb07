"""Horizontal fusion on the CPU (``engine/fused.py``): J same-shaped
tenants train as one ``torch.func.vmap``-ed step.

  * (a) the five ``autograd.Function``s (flash attention, the SSD scan,
    the RG-LRU scan, softmax cross-entropy, the causal conv) under
    ``vmap``, of the op and of ``grad``, equal J solo results at 1e-6
    (f32; the fold runs the same arithmetic on J x B rows), in grad mode
    and under ``no_grad``, with an input that has no jobs axis, and for
    SSD with B and C broadcast over heads (the plain version receives a
    stride-0 view);
  * (b) a guard on every kernel entry point: a fused step at every
    depth key never hands one a functorch-wrapped tensor and calls each
    as often as one solo step, at J x B rows;
  * (c) ``FusedEngine`` against J solo ``SPBEngine``s over one cycle:
    per-job loss, xent, grad_norm and every parameter leaf at 1e-5
    (batched products round in another order than J single ones; at the
    default learning rate 3e-4, as at 3e-3 AdamW's near-sign update moves
    an entry whose gradient cancels by a share of the rate that the
    gradient's last bits decide: one yi-6b-reduced entry ends 1.3e-5
    apart there, as ``tests/test_torch_temporal_mb.py`` describes);
  * (d) against the reference's ``FusedEngine`` from bridged weights:
    per-job loss and xent at the reference's own 1e-5
    (``tests/test_spatial.py``);
  * (e) the engine's surface: ``init_states``, ``init_state``,
    ``num_jobs``, ``attach_state``, ``stack_batches``, the functional
    step alone.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as j_steps
from repro.engine import FusedEngine as JFusedEngine
from repro.engine import stack_batches as j_stack_batches
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine import FusedEngine, SPBEngine, stack_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, rglru, rglru_bwd, ssd, ssd_bwd
from repro_torch.models import layers, ssm
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

J = 2
ARCHS = ["yi-6b", "mamba2-2.7b", "recurrentgemma-2b"]
VMAP_TOL = dict(rtol=1e-6, atol=1e-6)
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), use_pallas=True)


# ---------------------------------------------------------------------------
# (a) the vmap rules
# ---------------------------------------------------------------------------

def _flash(q, k, v):
    return ops.flash_attention(q, k, v, causal=True, window=6)


def _ssd(x, dA, b, c):
    y, state = ops.ssd(x, dA, b, c, chunk=8)
    return y * 0.5 + state.sum(dim=(-1, -2))[:, None, :, None]


def _xent(logits, labels):
    return layers.softmax_xent(logits, labels, valid_vocab=10)


def _inputs(op, rng):
    """(fn, per-job inputs with a leading jobs axis, the differentiable
    argnums)."""
    r = lambda *s: torch.from_numpy(rng.standard_normal((J,) + s)
                                    .astype(np.float32))
    if op == "flash_attention":
        return _flash, [r(2, 16, 4, 8), r(2, 16, 2, 8), r(2, 16, 2, 8)], \
            (0, 1, 2)
    if op == "ssd":
        # B and C: one group broadcast over 3 heads, a head stride of 0
        x, bc = r(2, 20, 3, 4), [r(2, 20, 1, 5).expand(J, 2, 20, 3, 5)
                                 for _ in "bc"]
        dA = -torch.from_numpy(rng.uniform(0.05, 2.0, (J, 2, 20, 3))
                               .astype(np.float32))
        return _ssd, [x, dA, *bc], (0, 1, 2, 3)
    if op == "rglru":
        a = torch.from_numpy(rng.uniform(0.1, 0.999, (J, 2, 20, 6))
                             .astype(np.float32))
        return ops.rglru, [a, r(2, 20, 6)], (0, 1)
    if op == "softmax_xent":
        labels = torch.from_numpy(rng.integers(0, 10, (J, 2, 7)))
        return _xent, [r(2, 7, 12), labels], (0,)
    if op == "causal_conv":
        return ssm.causal_conv, [r(2, 9, 5), r(4, 5), r(5)], (0, 1, 2)
    raise KeyError(op)


OPS = ["flash_attention", "ssd", "rglru", "softmax_xent", "causal_conv"]


def _solo(fn, args, argnums, j, unbatched=()):
    """Job j alone through eager autograd: (output, grads of the sum of
    squares)."""
    ts = [a if i in unbatched else a[j] for i, a in enumerate(args)]
    ts = [t.detach().clone().requires_grad_(i in argnums)
          for i, t in enumerate(ts)]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach(), [ts[i].grad for i in argnums]


@pytest.mark.parametrize("grad_mode", ["grad", "no_grad"])
@pytest.mark.parametrize("op", OPS)
def test_vmap_of_the_op_equals_solo_runs(op, grad_mode):
    fn, args, argnums = _inputs(op, np.random.default_rng(0))
    with torch.set_grad_enabled(grad_mode == "grad"):
        got = torch.func.vmap(fn)(*args)
    assert got.grad_fn is None
    for j in range(J):
        torch.testing.assert_close(got[j], _solo(fn, args, argnums, j)[0],
                                   **VMAP_TOL)


@pytest.mark.parametrize("op", OPS)
def test_vmap_of_grad_equals_solo_backward(op):
    fn, args, argnums = _inputs(op, np.random.default_rng(1))
    loss = lambda *a: (fn(*a).float() ** 2).sum()
    grads = torch.func.vmap(torch.func.grad(loss, argnums=argnums))(*args)
    for j in range(J):
        for got, want in zip(grads, _solo(fn, args, argnums, j)[1]):
            torch.testing.assert_close(got[j], want, **VMAP_TOL)


@pytest.mark.parametrize("op", ["flash_attention", "ssd", "rglru",
                                "causal_conv"])
def test_an_input_without_a_jobs_axis_is_expanded(op):
    """``in_dims`` None for the second input: every job sees the same
    tensor, as the solo runs are handed it."""
    fn, args, argnums = _inputs(op, np.random.default_rng(2))
    args[1] = args[1][0]
    in_dims = [0] * len(args)
    in_dims[1] = None
    loss = lambda *a: (fn(*a).float() ** 2).sum()
    out = torch.func.vmap(fn, in_dims=tuple(in_dims))(*args)
    grads = torch.func.vmap(torch.func.grad(loss, argnums=argnums),
                            in_dims=tuple(in_dims))(*args)
    for j in range(J):
        want_out, want_grads = _solo(fn, args, argnums, j, unbatched=(1,))
        torch.testing.assert_close(out[j], want_out, **VMAP_TOL)
        for got, want in zip(grads, want_grads):
            torch.testing.assert_close(got[j], want, **VMAP_TOL)


def test_ssd_fold_keeps_the_broadcast_heads_a_view(monkeypatch):
    """B and C at one group over the heads reach the plain versions as
    (J*B, S, H, N) views with a head stride of 0, in the forward, the
    forward with residuals and the backward."""
    strides = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(x, dA, b, c, *rest, **kw):
            strides.append((name, b.shape[0], b.stride(2), c.stride(2)))
            return real(x, dA, b, c, *rest, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(ssd, "ssd_fwd_plain")
    spy(ssd_bwd, "fwd_res_plain")
    spy(ssd_bwd, "bwd_plain")
    fn, args, argnums = _inputs("ssd", np.random.default_rng(3))
    with torch.no_grad():
        torch.func.vmap(fn)(*args)
    torch.func.vmap(torch.func.grad(lambda *a: fn(*a).sum(),
                                    argnums=argnums))(*args)
    assert [s[0] for s in strides] == ["ssd_fwd_plain", "fwd_res_plain",
                                       "bwd_plain"]
    assert all(s[1:] == (J * 2, 0, 0) for s in strides), strides


# ---------------------------------------------------------------------------
# (b) the kernel-entry guard
# ---------------------------------------------------------------------------

ENTRIES = [(fa, "fwd_kernel_layout"), (fab, "bwd_kernel_layout"),
           (fab, "compute_delta"), (fab, "compute_dq"), (fab, "compute_dkv"),
           (ssd, "ssd_fwd_kernel_layout"), (ssd_bwd, "fwd_res_kernel_layout"),
           (ssd_bwd, "bwd_kernel_layout"), (rglru, "rglru_scan"),
           (rglru_bwd, "bwd_kernel_layout")]


@pytest.fixture
def entry_log(monkeypatch):
    """Every kernel entry point wrapped: it asserts plain tensors and
    logs (entry, leading dim) per call."""
    log = []
    for module, name in ENTRIES:
        real = getattr(module, name)

        def guard(*args, _real=real, _key=f"{module.__name__}.{name}",
                  **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor):
                    assert not is_functorch_wrapped_tensor(a), _key
            log.append((_key, args[0].shape[0]))
            return _real(*args, **kw)
        monkeypatch.setattr(module, name, guard)
    return log


@pytest.mark.parametrize("arch", ARCHS)
def test_a_fused_step_calls_each_kernel_entry_once_per_solo_call(
        arch, entry_log):
    cfg = _cfg(arch)
    tcfg = TrainConfig(num_steps=8)
    batches = [Pipeline(cfg, 4, 16, seed=s).get_batch(0) for s in range(J)]
    for mode in ("temporal", "temporal-mb"):
        spb = SPBConfig(mode=mode, k=2)
        fused = FusedEngine(cfg, tcfg, spb, num_jobs=J, device="cpu")
        fused.init_states(list(range(J)))
        solo = SPBEngine(cfg, tcfg, spb, device="cpu")
        solo.init_state(0)
        keys = fused.depth_keys()
        assert keys == solo.depth_keys()
        assert ("mb" in keys) == (mode == "temporal-mb")
        for key in keys:
            entry_log.clear()
            solo.train_step(batches[0], depth=key)
            want = [(name, J * rows) for name, rows in entry_log]
            assert want, (arch, key)
            entry_log.clear()
            fused.train_step(stack_batches(batches), depth=key)
            assert entry_log == want, (arch, mode, key)


# ---------------------------------------------------------------------------
# (c) FusedEngine against J solo engines
# ---------------------------------------------------------------------------

CASES = [("yi-6b", "adamw", "temporal"), ("yi-6b", "sgdm", "temporal"),
         ("yi-6b", "adamw", "temporal-mb"), ("yi-6b", "sgdm", "temporal-mb"),
         ("mamba2-2.7b", "adamw", "temporal"),
         ("recurrentgemma-2b", "sgdm", "temporal-mb")]


@pytest.mark.parametrize("arch,optimizer,mode", CASES)
def test_fused_engine_equals_solo_engines(arch, optimizer, mode):
    cfg = _cfg(arch)
    tcfg = TrainConfig(optimizer=optimizer, num_steps=8)
    spb = SPBConfig(mode=mode, k=2)
    seeds = [3, 11]
    fused = FusedEngine(cfg, tcfg, spb, num_jobs=J, device="cpu")
    fused.init_states(seeds)
    solos = [SPBEngine(cfg, tcfg, spb, device="cpu") for _ in seeds]
    for eng, s in zip(solos, seeds):
        eng.init_state(s)
    pipes = [Pipeline(cfg, 4, 16, seed=s) for s in seeds]
    depths = []
    for step in range(2):            # one k=2 cycle
        batches = [p.get_batch(step) for p in pipes]
        per_job = fused.per_job_metrics(
            fused.train_step(stack_batches(batches), step))
        depths.append(fused.last_depth)
        for j, eng in enumerate(solos):
            want = eng.train_step(batches[j], step)
            assert eng.last_depth == fused.last_depth
            for k in ("loss", "xent", "grad_norm"):
                torch.testing.assert_close(per_job[j][k], want[k].detach(),
                                           **FUSED_TOL)
    assert fused.step_count == 2
    assert len(set(depths)) == (2 if mode == "temporal" else 1)
    for j, eng in enumerate(solos):
        for got, want in zip(tree_leaves(fused.state["params"]),
                             tree_leaves(eng.state["params"])):
            torch.testing.assert_close(got[j], want.detach(), **FUSED_TOL)


# ---------------------------------------------------------------------------
# (d) against the reference's FusedEngine
# ---------------------------------------------------------------------------

def test_fused_engine_equals_the_reference():
    """yi-6b-reduced, J = 2, 2 steps (depths 4 and 2) from the reference's
    stacked initial params, the same stacked batches."""
    jcfg = j_reduced("yi-6b")
    seeds = [0, 1]
    ref = JFusedEngine(jcfg, JTrain(seed=0, num_steps=16),
                       JSPB(mode="temporal", k=2), num_jobs=J)
    ref.init_states(seeds)
    params = bridge.stacked_params_from_numpy(
        jax.tree.map(np.asarray, ref.state["params"]), reduced_config("yi-6b"))
    tcfg = TrainConfig(seed=0, num_steps=16)
    ours = FusedEngine(reduced_config("yi-6b"), tcfg,
                       SPBConfig(mode="temporal", k=2), num_jobs=J,
                       device="cpu")
    ours.attach_state({"params": params,
                       "opt": optimizers.init_opt_state(params, tcfg),
                       "step": 0})
    pipes = [JPipeline(jcfg, 2, 16, seed=s) for s in seeds]
    for step in range(2):
        batch = j_stack_batches([p.get_batch(step) for p in pipes])
        want = ref.per_job_metrics(ref.train_step(batch, step))
        got = ours.per_job_metrics(ours.train_step(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
            step))
        assert ours.last_depth == ref.last_depth
        for j in range(J):
            for k in ("loss", "xent"):
                np.testing.assert_allclose(float(got[j][k]),
                                           float(want[j][k]),
                                           rtol=1e-5, atol=1e-6)


def _reference_params(seed):
    return jax.tree.map(np.asarray, j_steps.init_train_state(
        jax.random.key(seed), j_reduced("yi-6b"), JTrain())["params"])


def test_stacked_params_from_numpy_takes_j_trees_or_one_stack():
    cfg = reduced_config("yi-6b")
    trees = [_reference_params(s) for s in (0, 1)]
    from_list = bridge.stacked_params_from_numpy(trees, cfg)
    from_stack = bridge.stacked_params_from_numpy(
        jax.tree.map(lambda *xs: np.stack(xs), *trees), cfg)
    solo = [tree_leaves(bridge.params_from_numpy(t, cfg)) for t in trees]
    for a, b, t0, t1 in zip(tree_leaves(from_list), tree_leaves(from_stack),
                            *solo):
        assert not a.requires_grad and torch.equal(a, b)
        assert torch.equal(a[0], t0.detach())
        assert torch.equal(a[1], t1.detach())
    bad = dict(trees[1], final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm: expected shape"):
        bridge.stacked_params_from_numpy([trees[0], bad], cfg)
    with pytest.raises(ValueError, match="expected shape"):
        bridge.stacked_params_from_numpy(
            jax.tree.map(lambda x: np.stack([x, x])[:, None], trees[0]), cfg)


# ---------------------------------------------------------------------------
# (e) the engine's surface
# ---------------------------------------------------------------------------

def test_init_states_stacks_the_solo_inits():
    cfg = _cfg("mamba2-2.7b")
    fused = FusedEngine(cfg, TrainConfig(), SPBConfig(mode="temporal", k=2),
                        num_jobs=3, device="cpu")
    fused.init_states([5, 6, 7])
    assert fused.step_count == 0
    for j, seed in enumerate([5, 6, 7]):
        solo = SPBEngine(cfg, TrainConfig(), SPBConfig(mode="temporal", k=2),
                         device="cpu")
        solo.init_state(seed)
        for got, want in zip(tree_leaves(fused.state),
                             tree_leaves(solo.state)):
            if isinstance(want, torch.Tensor):
                assert not got.requires_grad
                assert got.shape == (3,) + want.shape
                assert torch.equal(got[j], want.detach())


def test_init_state_draws_one_seed_per_job():
    fused = FusedEngine(_cfg("yi-6b"), TrainConfig(),
                        SPBConfig(mode="temporal", k=2), num_jobs=J,
                        device="cpu")
    fused.init_state(0)
    first = fused.state["params"]["final_norm"].clone()
    emb = fused.state["params"]["embed"]["tok"]
    assert not torch.equal(emb[0], emb[1])
    fused.init_state(0)
    assert torch.equal(fused.state["params"]["final_norm"], first)


@pytest.mark.parametrize("num_jobs", [0, -1])
def test_num_jobs_below_one_raises(num_jobs):
    with pytest.raises(ValueError, match="num_jobs must be >= 1"):
        FusedEngine(_cfg("yi-6b"), TrainConfig(), num_jobs=num_jobs,
                    device="cpu")


def test_attach_state_checks_the_jobs_axis():
    cfg = _cfg("yi-6b")
    fused = FusedEngine(cfg, TrainConfig(), num_jobs=3, device="cpu")
    solo = SPBEngine(cfg, TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="jobs axis of 3"):
        fused.attach_state(solo.init_state(0))
    with pytest.raises(ValueError, match="3 seeds for"):
        FusedEngine(cfg, TrainConfig(), num_jobs=2,
                    device="cpu").init_states([0, 1, 2])


def test_stack_batches_equals_the_reference():
    cfg = reduced_config("yi-6b")
    ref = [JPipeline(j_reduced("yi-6b"), 2, 16, seed=s).get_batch(1)
           for s in range(3)]
    want = j_stack_batches(ref)
    got = stack_batches([{k: np.asarray(v) for k, v in b.items()}
                         for b in ref])
    ours = stack_batches([Pipeline(cfg, 2, 16, seed=s).get_batch(1)
                          for s in range(3)])
    assert set(got) == set(want) == set(ours)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert isinstance(ours[k], torch.Tensor)
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(want[k]))


def test_the_functional_step_alone_equals_the_solo_step():
    """No vmap: the functional step (gradients from ``torch.func.grad``,
    a frozen leaf's a zero tensor) moves a state as the eager step does,
    in place, returning the same objects."""
    cfg = _cfg("recurrentgemma-2b")
    tcfg = TrainConfig(num_steps=4, learning_rate=3e-3, microbatches=2)
    spb = SPBConfig(mode="temporal", k=2)
    eager = SPBEngine(cfg, tcfg, spb, device="cpu")
    eager.init_state(4)
    batch = Pipeline(cfg, 4, 16, seed=4).get_batch(0)
    params = [t.detach().clone() for t in tree_leaves(eager.state["params"])]
    pure = SPBEngine(cfg, tcfg, spb, device="cpu")
    state = pure.init_state(4)
    fn = steps_lib.make_functional_train_step(cfg, tcfg, spb, depth=3)
    got_p, got_o, got_m = fn(state["params"], state["opt"], 0, batch)
    assert got_p is state["params"] and got_o is state["opt"]
    want = eager.train_step(batch, 0, depth=3)
    for k in ("loss", "xent", "grad_norm", "lr"):
        torch.testing.assert_close(got_m[k], want[k].detach(), **VMAP_TOL)
    moved = 0
    for before, got, w in zip(params, tree_leaves(got_p),
                              tree_leaves(eager.state["params"])):
        torch.testing.assert_close(got.detach(), w.detach(), **VMAP_TOL)
        moved += not torch.equal(before, w.detach())
    assert moved == len(params)      # decay moves even the frozen leaves
