"""The port's hand-rolled optimizers and train step against the JAX
package's: one update from the same params, grads and state.

Tolerance 1e-6 relative (1e-9 absolute): the same f32 update formulas;
the port takes the learning rate and bias corrections in float64 where
JAX rounds them to f32, which moves the result by ~1e-7 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.dist import steps as jsteps
from repro.engine import SPBEngine as JEngine
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.dist import steps as tsteps
from repro_torch.engine.engine import SPBEngine
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-9)


def _trees(seed=0):
    cfg = j_reduced("yi-6b")
    rng = np.random.default_rng(seed)
    shapes = jlm.param_shapes(cfg)
    draw = lambda s, scale: (rng.standard_normal(s.shape) * scale).astype(
        np.float32)
    params = jax.tree.map(lambda s: draw(s, 0.1), shapes)
    grads = jax.tree.map(lambda s: draw(s, 1.0), shapes)
    return params, grads


def _to_torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32),
                                           dtype=dtype), tree)


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(optimizer, dtype):
    """Two updates (bias correction moves with the step) with global-norm
    clipping and SPB scaling; bf16 params go through f32 master copies."""
    jcfg, tcfg = j_reduced("yi-6b"), t_reduced("yi-6b")
    jt = JTrain(optimizer=optimizer, num_steps=10, grad_clip=1.0)
    tt = TrainConfig(optimizer=optimizer, num_steps=10, grad_clip=1.0)
    js, ts = JSPB(mode="temporal", k=4), SPBConfig(mode="temporal", k=4)
    params, grads = _trees()
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = _to_torch(params, getattr(torch, dtype))
    jstate, tstate = jopt.init_opt_state(jp, jt), topt.init_opt_state(tp, tt)
    assert set(jstate) == set(tstate)
    for step in range(2):
        jp, jstate, jm = jopt.apply_updates(jp, grads, jstate,
                                            jnp.asarray(step), jt, jcfg, js)
        tp, tstate, tm = topt.apply_updates(tp, _to_torch(grads), tstate,
                                            step, tt, tcfg, ts)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL)
    for key in jstate:
        for a, b in zip(jax.tree.leaves(jstate[key]),
                        jax.tree.leaves(tstate[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                       err_msg=key)
    master = tstate.get("master", tp)
    for p, m in zip(tree_leaves(tp), tree_leaves(master)):
        assert torch.equal(p, m.to(p.dtype))


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
def test_none_grad_counts_as_zero(optimizer):
    """A parameter autograd left without a gradient (a fully frozen group)
    is updated exactly as with a zero gradient: after a first step with
    real gradients, its moments decay and its weight decay applies."""
    tt = TrainConfig(optimizer=optimizer)
    params, grads = _trees(1)
    moment = "mu" if optimizer == "adamw" else "mom"
    out = []
    for frozen in (torch.zeros_like, lambda t: None):
        p = _to_torch(params)
        state = topt.init_opt_state(p, tt)
        p, state, _ = topt.apply_updates(p, _to_torch(grads), state, 0, tt)
        first = state[moment]["groups"][0][0]["ffn"]["wg"].clone()
        mid = p["groups"][0][0]["ffn"]["wg"].detach().clone()
        g = _to_torch(grads)
        g["groups"][0][0]["ffn"]["wg"] = frozen(g["groups"][0][0]["ffn"]["wg"])
        p, state, _ = topt.apply_updates(p, g, state, 1, tt)
        out.append((p, state))
    (pa, sa), (pb, sb) = out
    for a, b in zip(tree_leaves([pa, sa]), tree_leaves([pb, sb])):
        assert torch.equal(a, b)
    after = sb[moment]["groups"][0][0]["ffn"]["wg"]
    want = (first * tt.beta1 if optimizer == "adamw"      # decayed moment
            else first * tt.momentum + tt.weight_decay * mid)
    torch.testing.assert_close(after, want)


def test_lr_schedule_matches_jax():
    jt, tt = JTrain(num_steps=20, warmup_steps=5), TrainConfig(
        num_steps=20, warmup_steps=5)
    for step in range(25):
        np.testing.assert_allclose(
            topt.lr_at(tt, step), float(jopt.lr_at(jt, jnp.asarray(step))),
            rtol=1e-6)


def test_microbatched_step_matches_jax():
    """make_train_step with 2 microbatches at SPB depth 2: gradients sum
    over the chunks then average, metrics average; f32, plain attention.
    Metrics and the first moment (0.1 x the clipped gradient) agree to 2e-5
    relative: four layers of f32 summed in another order.  Params agree to
    1e-6 absolute, 3% of the step's lr: AdamW's first update is
    g / (|g| + eps), so an element whose gradient is near zero can move by
    a visible fraction of lr under rounding noise in g."""
    jcfg, tcfg = j_reduced("yi-6b"), t_reduced("yi-6b")
    jt, tt = JTrain(microbatches=2), TrainConfig(microbatches=2)
    js, ts = JSPB(mode="temporal", k=4), SPBConfig(mode="temporal", k=4)
    jstate = jsteps.init_train_state(jax.random.key(0), jcfg, jt)
    params = jax.tree.map(np.asarray, jstate["params"])
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 512, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, jt, js, depth=2))(
        jstate, batch)
    tstate = tsteps.state_from_params(bridge.params_from_numpy(params, tcfg),
                                      tt)
    tnew, tm = tsteps.make_train_step(tcfg, tt, ts, depth=2)(
        tstate, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    for key in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-5)
    assert tnew["step"] == int(jnew["step"]) == 1
    # jax.tree.leaves orders both trees by sorted keys
    for a, b in zip(jax.tree.leaves(jnew["opt"]["mu"]),
                    jax.tree.leaves(tnew["opt"]["mu"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-8)
    for a, b in zip(jax.tree.leaves(jnew["params"]),
                    jax.tree.leaves(tnew["params"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-6)


def test_engine_step_table_and_depths_match_jax():
    spb = dict(mode="temporal", k=4, warmup_steps=1)
    jcfg = dataclasses.replace(j_reduced("yi-6b"), num_layers=8)
    tcfg = dataclasses.replace(t_reduced("yi-6b"), num_layers=8)
    je = JEngine(jcfg, JTrain(), JSPB(**spb))
    te = SPBEngine(tcfg, TrainConfig(), SPBConfig(**spb), device="cpu")
    assert je.depth_keys() == te.depth_keys()
    assert [je.resolve_depth(d) for d in (None, 1, 3, 7, 9)] == \
        [te.resolve_depth(d) for d in (None, 1, 3, 7, 9)]
    assert [je.depth_key_for_step(s) for s in range(10)] == \
        [te.depth_key_for_step(s) for s in range(10)]
