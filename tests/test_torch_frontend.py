"""internvl2-26b's modality frontend in the port against the JAX package on
internvl2-reduced (4 GQA layers, 8 stub patch embeddings before the text,
f32): the parameter tree, the logits of the text positions, the loss and
every gradient leaf at every snapped temporal k=4 depth, with the
kernels' plain versions and without, the Pipeline's batches,
``make_batch``, a 3-step ``make_train_step`` run and the train driver.

Tolerance 1e-5 of each leaf's largest entry (logits: of the largest
logit): the same f32 arithmetic summed in another order.  The 3-step run
compares losses at 1e-4 relative, as tests/test_torch_train.py does."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB
from repro.config import TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.core import spb as jspb
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as jsteps
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as tsteps
from repro_torch.launch import train as train_mod
from repro_torch.models import lm as tlm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ARCH = "internvl2-26b"
TOL = 1e-5
DEPTHS = sorted(set(jspb.snapped_depths(j_reduced(ARCH),
                                        JSPB(mode="temporal", k=4))))


def _setup(seed=0, B=2, S=64):
    """Params and a batch of S positions: frontend_tokens patch embeddings,
    then S - frontend_tokens text tokens."""
    jcfg = dataclasses.replace(j_reduced(ARCH), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 7)
    F, T = jcfg.frontend_tokens, S - jcfg.frontend_tokens
    batch = {"frontend": (rng.normal(size=(B, F, jcfg.d_model)) * 0.5
                          ).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, T)).astype(
                 np.int32)}
    return jcfg, params, batch


@functools.lru_cache(maxsize=None)
def _reference(depth):
    """The reference's (loss, gradient tree) at ``depth``."""
    jcfg, params, batch = _setup()
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batch, jcfg, bwd_layers=depth),
        has_aux=True)(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _tcfg(use_pallas):
    return dataclasses.replace(t_reduced(ARCH), use_pallas=use_pallas)


def _tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(initial=0.0)
    assert err <= TOL * np.abs(want).max(initial=0.0), \
        f"{what}: max err {err:.3e} of max {np.abs(want).max():.3e}"


def test_param_tree_and_bridge_match_the_reference():
    """A frontend adds no parameter: the reference's leaves, shapes and
    dtypes, bridged leaf for leaf."""
    jcfg, params, _ = _setup()
    tcfg = _tcfg(True)
    shapes = tlm.param_shapes(tcfg)
    assert set(shapes) == {"embed", "groups", "final_norm"}
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.key(0))
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(shapes),
                    strict=True):
        assert (w.shape, str(w.dtype)) == \
            (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    tp = bridge.params_from_numpy(params, tcfg)
    for w, g in zip(jax.tree.leaves(params), jax.tree.leaves(tp),
                    strict=True):
        np.testing.assert_array_equal(g.detach().numpy(), w)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_train_logits_of_the_text_match(use_pallas):
    jcfg, params, batch = _setup()
    want, waux = jlm.forward_train(params, batch, jcfg)
    tcfg = _tcfg(use_pallas)
    tp = bridge.params_from_numpy(params, tcfg)
    got, aux = tlm.forward_train(tp, _tb(batch), tcfg)
    assert tuple(got.shape) == batch["tokens"].shape + (tcfg.padded_vocab,)
    _close(got.detach(), want, "logits")
    assert float(aux) == float(waux) == 0.0
    # the patches are context: without them the text's logits change
    text_only = {k: v for k, v in _tb(batch).items() if k != "frontend"}
    alone, _ = tlm.forward_train(tp, text_only, tcfg)
    assert (alone - got).abs().max() > 1e-3


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
def test_loss_and_every_gradient_leaf_match(depth, use_pallas):
    jcfg, params, batch = _setup()
    wloss, jg = _reference(depth)
    tcfg = _tcfg(use_pallas)
    tp = bridge.params_from_numpy(params, tcfg)
    loss, _ = tlm.loss_fn(tp, _tb(batch), tcfg, bwd_layers=depth)
    loss.backward()
    _close(float(loss.detach()), wloss, "loss")
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, w), p in zip(paths, jax.tree.leaves(tp), strict=True):
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        name = jax.tree_util.keystr(path)
        _close(g, w, name)
        if "groups" in name:        # the frozen rows: exactly zero
            frozen = ~np.any(w.reshape(len(w), -1), axis=1)
            assert frozen.sum() == jcfg.num_layers - depth
            assert not np.any(g[frozen]), name


def test_pipeline_batches_equal_the_reference():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    for s in range(2):
        want = JPipeline(jcfg, 2, 24, seed=3).get_batch(s)
        got = Pipeline(tcfg, 2, 24, seed=3).get_batch(s)
        assert set(got) == set(want) == {"tokens", "labels", "frontend"}
        assert tuple(got["tokens"].shape) == (2, 24 - tcfg.frontend_tokens)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_batch_puts_the_frontend_before_the_text():
    for dtype in ("float32", "bfloat16"):
        cfg = t_reduced(ARCH).scaled(dtype=dtype)
        b = make_batch(cfg, 2, 40, seed=1, device="cpu")
        assert {k: tuple(v.shape) for k, v in b.items()} == {
            "tokens": (2, 32), "labels": (2, 32), "frontend": (2, 8, 64)}
        assert b["frontend"].dtype == getattr(torch, dtype)


def test_three_train_steps_match_the_reference():
    """make_train_step at the cycle's first three depths (4, 1, 3), SPB
    temporal with the per-layer update scaling, from bridged weights."""
    jcfg, params, _ = _setup()
    spb = dict(mode="temporal", k=4)
    jstate = jsteps.init_train_state(jax.random.key(0), jcfg, JTrain())
    jstate["params"] = jax.tree.map(jnp.asarray, params)
    tcfg, ttrain = _tcfg(True), TrainConfig()
    tstate = tsteps.state_from_params(bridge.params_from_numpy(params, tcfg),
                                      ttrain)
    jpipe, tpipe = JPipeline(jcfg, 2, 32, seed=1), Pipeline(tcfg, 2, 32,
                                                            seed=1)
    for s, depth in enumerate((4, 1, 3)):
        jstate, jm = jsteps.make_train_step(jcfg, JTrain(), JSPB(**spb),
                                            depth=depth)(
            jstate, jpipe.get_batch(s))
        tstate, tm = tsteps.make_train_step(tcfg, ttrain, SPBConfig(**spb),
                                            depth=depth)(
            tstate, tpipe.get_batch(s))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {s} {k}")


def test_train_driver_runs_on_cpu(capsys):
    """The driver's defaults (batch 8 x 128 positions: 8 patches, 120 text
    tokens), temporal SPB with the kernels' plain versions."""
    history = train_mod.train(["--arch", ARCH, "--steps", "2", "--spb-mode",
                               "temporal", "--use-pallas", "--device", "cpu",
                               "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(history) == 2 and all(np.isfinite(history))
    assert "[train] step=    0 depth=   4 loss=" in out
    assert "[train] step=    1 depth=   1 loss=" in out
