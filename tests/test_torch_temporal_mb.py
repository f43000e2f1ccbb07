"""temporal-mb SPB end to end on the CPU: the port's SPBEngine against the
JAX SPBEngine, both in ``temporal-mb`` mode (one step runs the whole k=4
depth cycle as four accumulated microbatches, then one optimizer step),
from bridged weights and the same Pipeline batches (4 x 64, f32, kernels
on: the JAX kernels in interpret mode, the port's plain versions), 3 steps.
loss, xent, grad_norm and lr agree step by step, and every parameter leaf
after the last step: to 1e-6 relative on yi-6b-reduced (the same f32
arithmetic summed in another order), to 1e-4 on the SSM configs (the
reference's float32 running sums in its scans, ROADMAP "Reference
caveats").

Every parameter leaf is held after the last step at the measure the scan
kernels' tests use, max|got - want| / max(max|want|, 1): to 1e-4 on the SSM
configs and to 1e-5 on yi-6b-reduced.  The gradients themselves agree to
about 1e-6 of each leaf's largest entry (the second test holds the first
cycle's accumulated gradients at 1e-5), but AdamW moves an entry whose
gradient cancels to near zero by a share of the learning rate that the
gradient's last bits decide: on yi-6b-reduced one wk entry ends 2.8e-6
apart, where the same 3 steps in ``temporal`` mode end 1.0e-7 apart on
that leaf and 7.5e-7 on the worst one.
"""
import dataclasses

import jax
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.core import spb as j_spb
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as j_steps
from repro.engine import SPBEngine as JEngine
from repro.models import lm as j_lm
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

STEPS, BATCH, SEQ = 3, 4, 64
ARCHS = ["yi-6b", "mamba2-2.7b", "recurrentgemma-2b"]
TOL = {"yi-6b": 1e-6, "mamba2-2.7b": 1e-4, "recurrentgemma-2b": 1e-4}
PARAM_TOL = {"yi-6b": 1e-5, "mamba2-2.7b": 1e-4, "recurrentgemma-2b": 1e-4}
GRAD_TOL = 1e-5


def _max_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1))


def _jax_run(arch):
    cfg = dataclasses.replace(j_reduced(arch), use_pallas=True)
    eng = JEngine(cfg, JTrain(num_steps=STEPS),
                  JSPB(mode="temporal-mb", k=4))
    eng.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, eng.state["params"])
    pipe = JPipeline(cfg, BATCH, SEQ, seed=0)
    history = []
    for s in range(STEPS):
        m = eng.train_step(pipe.get_batch(s), s)
        history.append((eng.last_depth, {k: float(v) for k, v in m.items()}))
    return params, history, jax.tree.map(np.asarray, eng.state["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_temporal_mb_tracks_jax_step_by_step(arch):
    params, want, want_params = _jax_run(arch)
    tol = TOL[arch]
    cfg = dataclasses.replace(t_reduced(arch), use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal-mb", k=4),
                    device="cpu")
    assert set(eng.depth_keys()) == {None, "mb"}
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, BATCH, SEQ, seed=0)
    for s, (jdepth, jm) in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        assert eng.last_depth == jdepth == "mb"
        assert set(m) == set(jm)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=tol,
                                       err_msg=f"{arch} step {s} {key}")
    got = tree_leaves(eng.state["params"])
    ref = tree_leaves(bridge.params_from_numpy(want_params, cfg))
    assert len(got) == len(ref)
    for i, (g, w) in enumerate(zip(got, ref)):
        err = _max_err(g.detach().numpy(), w.detach().numpy())
        assert err <= PARAM_TOL[arch], f"{arch} leaf {i}: {err:.3e}"
    assert eng.step_count == STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_temporal_mb_accumulates_the_cycles_gradients(arch):
    """The gradients one temporal-mb step hands the optimizer: each
    microbatch's backward at its cycle depth accumulates in ``.grad`` --
    the frozen rows of a split group take nothing from that microbatch,
    and keep what the deeper ones put there -- equal to the reference's
    sum of the four per-depth gradients, to 1e-5 of each leaf's largest
    entry (f32 sums in another order)."""
    jcfg = dataclasses.replace(j_reduced(arch), use_pallas=True)
    params = j_lm.init_lm(jax.random.key(0), jcfg)
    chunks = j_steps._microbatches(
        JPipeline(jcfg, BATCH, SEQ, seed=0).get_batch(0), 4)
    sched = j_spb.make_schedule(jcfg, JSPB(mode="temporal-mb", k=4))
    cycle = [sched.depths[i] for i in sched.order]

    @jax.jit
    def cycle_grads(params, chunks):
        want = None
        for chunk, d in zip(chunks, cycle):
            _, g = j_steps._grad_fn(jcfg, d)(params, chunk)
            want = g if want is None else jax.tree.map(jnp.add, want, g)
        return want

    want = cycle_grads(params, chunks)

    cfg = dataclasses.replace(t_reduced(arch), use_pallas=True)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    steps_lib._accumulate(
        {"params": tparams},
        [{k: torch.as_tensor(np.array(v)) for k, v in c.items()}
         for c in chunks], cycle, cfg)
    ref = tree_leaves(bridge.params_from_numpy(
        jax.tree.map(np.asarray, want), cfg))
    for i, (p, w) in enumerate(zip(tree_leaves(tparams), ref)):
        w = w.detach().numpy()
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = float(np.abs(got - w).max() / np.abs(w).max())
        assert err <= GRAD_TOL, f"{arch} leaf {i}: {err:.3e}"
