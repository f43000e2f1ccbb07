"""seamless-m4t-medium's encoder-decoder in the port against the JAX package
on seamless-reduced (2 bidirectional encoder layers, 2 ``xdec`` decoder
layers, f32): the cross-attention layer (train and decode), the logits,
the loss and every gradient leaf (``enc`` included) at every snapped
temporal k=4 depth, with the kernels' plain versions and without, the
Pipeline's batches, ``make_batch``, a 3-step ``make_train_step`` run and
the train driver's restart from a checkpoint.

The SPB depth counts over the combined stack, encoder first: depth 1
freezes the encoder and decoder layer 0, depth 2 the encoder, depth 3
encoder layer 0.  At depths 2 and 3 the decoder's token embedding is live
(the boundary lies at or inside the encoder), which the tied embedding's
gradient pins.

One difference is by design.  The reference's frozen decoder layers
stop the gradient of their input and weights but not of the encoder
output they cross-attend to, so at depth 1 its gradient runs back
through frozen decoder layer 0 into ``enc.final_norm``.  The port's
frozen layers run under ``no_grad`` (no backward in a frozen layer), so
its ``enc.final_norm`` gradient is the live layers' part alone.  The
gradient tests hold the port against the reference's own forward with
the encoder output stopped in frozen groups (:func:`_stopped_run_stack`,
the reference's ``_run_stack`` with that one change), and
``test_reference_gradient_differs_only_in_enc_final_norm`` pins that this
changes nothing but that leaf.

Tolerance 1e-5 of each leaf's largest entry (logits: of the largest
logit): the same f32 arithmetic summed in another order.  The 3-step run
compares losses at 1e-4 relative, as tests/test_torch_train.py does
(four AdamW updates compound the rounding)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.config import SPBConfig as JSPB
from repro.config import TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.core import spb as jspb
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as jsteps
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as tsteps
from repro_torch.launch import train as train_mod
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = 1e-5
DEPTHS = sorted(set(jspb.snapped_depths(j_reduced(ARCH),
                                        JSPB(mode="temporal", k=4))))


def _stopped_run_stack(x, aux, groups, cfg, positions, boundary, base, *,
                       enc=None, causal=True):
    """``repro.models.lm._run_stack`` with the encoder output stopped in
    the frozen groups, as the port runs them."""
    specs, offs = jlm._stack_groups({}, cfg)
    sg_enc = None if enc is None else lax.stop_gradient(enc)
    for (unit, count), off, gparams in zip(specs, offs, groups):
        p = len(unit)
        lo, hi = base + off, base + off + p * count
        if boundary >= hi:
            sg = jax.tree.map(lax.stop_gradient, gparams)
            x, aux = jlm._run_group_train(lax.stop_gradient(x), aux, sg, unit,
                                          cfg, positions, enc=sg_enc,
                                          causal=causal)
        elif boundary <= lo:
            x, aux = jlm._run_group_train(x, aux, gparams, unit, cfg,
                                          positions, enc=enc, causal=causal)
        else:
            frozen, live = jlm._split_group(gparams, (boundary - lo) // p)
            sg = jax.tree.map(lax.stop_gradient, frozen)
            x, aux = jlm._run_group_train(lax.stop_gradient(x), aux, sg, unit,
                                          cfg, positions, enc=sg_enc,
                                          causal=causal)
            x, aux = jlm._run_group_train(x, aux, live, unit, cfg, positions,
                                          enc=enc, causal=causal)
    return x, aux


@pytest.fixture
def stopped_reference(monkeypatch):
    monkeypatch.setattr(jlm, "_run_stack", _stopped_run_stack)


@functools.lru_cache(maxsize=None)
def _reference(depth, stopped=True):
    """The reference's (loss, gradient tree) at ``depth`` on :func:`_setup`'s
    inputs, with the encoder output stopped in frozen groups or not."""
    jcfg, params, batch = _setup()
    with pytest.MonkeyPatch.context() as mp:
        if stopped:
            mp.setattr(jlm, "_run_stack", _stopped_run_stack)
        (loss, _), grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, batch, jcfg, bwd_layers=depth),
            has_aux=True)(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _setup(seed=0, B=2, S=64):
    jcfg = dataclasses.replace(j_reduced(ARCH), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 5)
    batch = {"frames": (rng.normal(size=(B, S, jcfg.d_model)) * 0.5
                        ).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                 np.int32)}
    return jcfg, params, batch


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


def _grad(p):
    return None if p.grad is None else p.grad.numpy()


def test_param_tree_and_bridge_match_the_reference():
    """``enc`` = {groups, final_norm} and the xdec layer's xattn/lnx: the
    reference's leaves, shapes and dtypes; the port's init zeros every
    norm (lnx among them) and draws every projection."""
    jcfg, params, _ = _setup()
    tcfg = _tcfg(True)
    shapes = tlm.param_shapes(tcfg)
    assert set(shapes) == {"embed", "groups", "final_norm", "enc"}
    assert set(shapes["groups"][0][0]) == {"ln1", "mixer", "xattn", "lnx",
                                           "ln2", "ffn"}
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.key(0))
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(shapes),
                    strict=True):
        assert (w.shape, str(w.dtype)) == \
            (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    init = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    layer = init["groups"][0][0]
    assert bool((layer["lnx"] == 0).all()) and \
        bool((init["enc"]["final_norm"] == 0).all())
    assert float(layer["xattn"]["wk"].std()) > 0
    tp = bridge.params_from_numpy(params, tcfg)
    for w, g in zip(jax.tree.leaves(params), jax.tree.leaves(tp),
                    strict=True):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_cross_attention_fwd_values_and_grads_match_the_reference():
    cfg = j_reduced(ARCH)
    p = jax.tree.map(np.asarray, JL.init_cross_attention(
        jax.random.key(3), cfg, jnp.float32))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)

    def jfn(p, x, enc):
        return jnp.sum(JL.cross_attention_fwd(p, x, enc, cfg) * ct)

    want = JL.cross_attention_fwd(p, x, enc, cfg)
    jg = jax.grad(jfn, argnums=(0, 1, 2))(p, x, enc)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx, te = (torch.tensor(a, requires_grad=True) for a in (x, enc))
    got = TL.cross_attention_fwd(tp, tx, te, _tcfg(False))
    (got * torch.from_numpy(ct)).sum().backward()
    _close(got.detach(), want, "cross_attention_fwd")
    for k in p:
        _close(tp[k].grad, jg[0][k], f"d{k}")
    _close(tx.grad, jg[1], "dx")
    _close(te.grad, jg[2], "denc")


def test_cross_attention_decode_matches_the_reference():
    cfg = j_reduced(ARCH)
    p = jax.tree.map(np.asarray, JL.init_cross_attention(
        jax.random.key(4), cfg, jnp.float32))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    kv = tuple(rng.normal(size=(2, 40, cfg.num_kv_heads, cfg.head_dim)
                          ).astype(np.float32) for _ in "kv")
    want = JL.cross_attention_decode(p, x, cfg, kv)
    got = TL.cross_attention_decode(
        {k: torch.tensor(v) for k, v in p.items()}, torch.from_numpy(x),
        _tcfg(False), tuple(torch.from_numpy(t) for t in kv))
    _close(got, want, "cross_attention_decode")


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_train_logits_and_aux_match(use_pallas):
    jcfg, params, batch = _setup()
    want, waux = jlm.forward_train(params, batch, jcfg)
    tcfg = _tcfg(use_pallas)
    got, aux = tlm.forward_train(bridge.params_from_numpy(params, tcfg),
                                 _tb(batch), tcfg)
    _close(got.detach(), want, "logits")
    assert float(aux) == float(waux) == 0.0


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
        w, g = np.asarray(w), _grad(p)
        g = np.zeros_like(w) if g is None else g
        name = jax.tree_util.keystr(path)
        _close(g, w, name)
        if "groups" in name:        # the frozen rows: exactly zero
            frozen = ~np.any(w.reshape(len(w), -1), axis=1)
            assert not np.any(g[frozen]), name
    # the flat layers below the boundary got nothing; the tied embedding's
    # lookup is live while the boundary lies in the encoder
    total = jcfg.enc_layers + jcfg.num_layers
    frozen_enc = min(total - depth, jcfg.enc_layers)
    enc_wq = tp["enc"]["groups"][0][0]["mixer"]["wq"].grad
    assert enc_wq is None or not enc_wq[:frozen_enc].any()
    if frozen_enc < jcfg.enc_layers:
        assert enc_wq[frozen_enc:].abs().max() > 0


@pytest.mark.parametrize("depth", DEPTHS)
def test_reference_gradient_differs_only_in_enc_final_norm(depth):
    """The reference's own gradient equals the stopped one (which the port
    matches) in every leaf, but at depth 1 in ``enc.final_norm``, which
    there also takes the path back through frozen decoder layer 0."""
    (leaky_loss, leaky), (loss, stopped) = (_reference(depth, False),
                                            _reference(depth))
    assert leaky_loss == loss
    paths = jax.tree_util.tree_flatten_with_path(leaky)[0]
    for (path, a), b in zip(paths, jax.tree.leaves(stopped), strict=True):
        name = jax.tree_util.keystr(path)
        if name == "['enc']['final_norm']" and depth == 1:
            assert np.abs(a - b).max() > 0.1 * np.abs(b).max()
        else:
            _close(a, b, name)


def test_pipeline_batches_equal_the_reference():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    for s in range(2):
        want = JPipeline(jcfg, 2, 24, seed=3).get_batch(s)
        got = Pipeline(tcfg, 2, 24, seed=3).get_batch(s)
        assert set(got) == set(want) == {"tokens", "labels", "frames"}
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    bf16 = Pipeline(tcfg.scaled(dtype="bfloat16"), 2, 24).get_batch(0)
    assert bf16["frames"].dtype == torch.bfloat16


def test_make_batch_holds_frames_for_the_encoder():
    for dtype in ("float32", "bfloat16"):
        cfg = t_reduced(ARCH).scaled(dtype=dtype)
        b = make_batch(cfg, 2, 40, seed=1, device="cpu")
        assert {k: tuple(v.shape) for k, v in b.items()} == {
            "tokens": (2, 40), "labels": (2, 40), "frames": (2, 40, 64)}
        assert b["frames"].dtype == getattr(torch, dtype)
        again = make_batch(cfg, 2, 40, seed=1, device="cpu")
        assert all(torch.equal(b[k], again[k]) for k in b)


def test_three_train_steps_match_the_reference(stopped_reference):
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


def test_train_driver_restarts_from_a_checkpoint_with_the_encoder(tmp_path,
                                                                  capsys):
    """The driver on the CPU: temporal SPB over the combined stack (depths
    4, 1, 3, 2), a failure injected at step 3 and resumed from the step-2
    checkpoint (which holds ``enc``), ending on the straight run's xent."""
    args = ["--arch", ARCH, "--steps", "4", "--batch", "2", "--seq", "32",
            "--spb-mode", "temporal", "--use-pallas", "--device", "cpu",
            "--log-every", "1", "--checkpoint-every", "2"]
    straight = train_mod.train(args + ["--checkpoint-dir",
                                       str(tmp_path / "a")])
    failed = train_mod.train(args + ["--checkpoint-dir", str(tmp_path / "b"),
                                     "--fail-at", "3"])
    out = capsys.readouterr().out
    assert all(np.isfinite(straight)) and len(straight) == 4
    for step, depth in enumerate((4, 1, 3, 2)):
        assert f"[train] step={step:5d} depth={depth:4d} loss=" in out
    assert "[train] resumed from step 2" in out
    np.testing.assert_allclose(failed[-1], straight[-1], rtol=1e-5)
