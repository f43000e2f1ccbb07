"""The port's LM on weights bridged from the JAX package: the bridge is a
checked name-by-name copy, the logits match, and SPB partial backprop
gives JAX's suffix gradients with a zero (or absent) prefix gradient,
for yi-6b-reduced, mamba2-reduced, recurrentgemma-reduced, gemma3-reduced,
deepseek-67b-reduced and qwen3-moe-reduced (with its MoE aux loss), and
the MLA archs deepseek-v2-lite-reduced (MLA with a dense layer 0 and MoE
layers) and minicpm3-reduced (MLA with q-lora), with the kernels' padded
route and without.

Tolerance 2e-4: four f32 layers whose attention goes through the kernels'
plain versions on one side and the Pallas kernels (interpret mode) on the
other, the repo's flash-attention tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB
from repro.config import layer_groups as jc_layer_groups
from repro.configs import reduced_config as j_reduced
from repro.core import spb as jspb
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import lm as tlm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_reduced("yi-6b"), use_pallas=True)
    tcfg = dataclasses.replace(t_reduced("yi-6b"), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, tcfg, params, {"tokens": tokens, "labels": labels}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def test_bridge_copies_every_leaf(setup):
    _, tcfg, params, _ = setup
    got = bridge.params_from_numpy(params, tcfg)
    want_leaves = jax.tree.leaves(params)
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves) == 11
    for w, g in zip(want_leaves, got_leaves):
        assert g.requires_grad and g.is_leaf
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_bridge_rejects_missing_extra_and_misshaped_leaves(setup):
    _, tcfg, params, _ = setup
    missing = jax.tree.map(lambda x: x, params)
    del missing["groups"][0][0]["mixer"]["wq"]
    with pytest.raises(KeyError, match="wq"):
        bridge.params_from_numpy(missing, tcfg)
    extra = jax.tree.map(lambda x: x, params)
    extra["embed"]["unembed"] = np.zeros((64, 512), np.float32)
    with pytest.raises(KeyError, match="unembed"):
        bridge.params_from_numpy(extra, tcfg)
    bad = jax.tree.map(lambda x: x, params)
    bad["final_norm"] = np.zeros((65,), np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        bridge.params_from_numpy(bad, tcfg)


def test_forward_train_logits_match(setup):
    jcfg, tcfg, params, batch = setup
    want, _ = jlm.forward_train(params, batch, jcfg)
    got, _ = tlm.forward_train(bridge.params_from_numpy(params, tcfg),
                               _tbatch(batch), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _suffix_grads(setup, depth):
    jcfg, tcfg, params, batch = setup
    jg = jax.grad(lambda p: jlm.loss_fn(p, batch, jcfg,
                                        bwd_layers=depth)[0])(params)
    tp = bridge.params_from_numpy(params, tcfg)
    loss, _ = tlm.loss_fn(tp, _tbatch(batch), tcfg, bwd_layers=depth)
    loss.backward()
    return jg, tp


@pytest.mark.parametrize("depth", jspb.snapped_depths(
    j_reduced("yi-6b"), JSPB(mode="temporal", k=4)))
def test_suffix_grads_match_and_prefix_is_zero(setup, depth):
    jcfg = setup[0]
    jg, tp = _suffix_grads(setup, depth)
    b = jcfg.num_layers - depth
    for w, p in zip(jax.tree.leaves(jg["groups"]),
                    jax.tree.leaves(tp["groups"])):
        w = np.asarray(w)
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g[:b]).max(initial=0.0) == 0.0
        np.testing.assert_allclose(g[b:], w[b:], **TOL)
    for key in ("embed", "final_norm"):
        for w, p in zip(jax.tree.leaves(jg[key]),
                        jax.tree.leaves(tp[key])):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# mamba2-reduced: the SSD stack, kernels on (their plain versions here)
# ---------------------------------------------------------------------------

# 1e-5 relative to the largest entry (max(.., 1)): four f32 SSD layers, the
# same f32 math summed in another order (the SSD suite's tolerance).
SSD_TOL = 1e-5


def _rel_close(got, want, tol=SSD_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max(initial=0.0) / max(np.abs(want).max(
        initial=0.0), 1.0)
    assert err <= tol, f"rel err {err:.3e} > {tol:g}"


@pytest.fixture(scope="module")
def mamba2():
    jcfg = dataclasses.replace(j_reduced("mamba2-2.7b"), use_pallas=True)
    tcfg = dataclasses.replace(t_reduced("mamba2-2.7b"), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    return jcfg, tcfg, params, {"tokens": tokens, "labels": labels}


def test_mamba2_leaf_dtypes_equal_jax_at_bf16():
    """At bf16 the SSM's A_log, D and dt_bias stay f32, in the layout, in
    the port's init and through the bridge."""
    jcfg = j_reduced("mamba2-2.7b").scaled(dtype="bfloat16")
    tcfg = t_reduced("mamba2-2.7b").scaled(dtype="bfloat16")
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.key(0))
    shapes = tlm.param_shapes(tcfg)
    tdt = lambda t: str(t.dtype).removeprefix("torch.")
    for w, s in zip(jax.tree.leaves(want), jax.tree.leaves(shapes)):
        assert (tuple(w.shape), str(w.dtype)) == (tuple(s.shape), tdt(s))
    init = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    for s, t in zip(jax.tree.leaves(shapes), jax.tree.leaves(init)):
        assert (t.shape, t.dtype) == (s.shape, s.dtype)
    mixer = want["groups"][0][0]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype == jnp.float32} == \
        {"A_log", "D", "dt_bias"}
    numpy_tree = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), want)
    bridged = bridge.params_from_numpy(numpy_tree, tcfg)
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(bridged)):
        assert tdt(t) == str(w.dtype)


def test_mamba2_init_follows_jax_rules():
    tcfg = t_reduced("mamba2-2.7b")
    p = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    m = p["groups"][0][0]["mixer"]
    H = m["A_log"].shape[-1]
    torch.testing.assert_close(m["A_log"][0], torch.log(torch.linspace(
        1.0, 16.0, H)))
    assert bool((m["D"] == 1).all()) and bool((m["norm"] == 0).all())
    assert bool((m["conv_b"] == 0).all())
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert abs(float(m["conv_w"].std()) * 2.0 - 1.0) < 0.1     # 1/sqrt(4)


def test_mamba2_bridge_copies_every_leaf(mamba2):
    _, tcfg, params, _ = mamba2
    got = bridge.params_from_numpy(params, tcfg)
    want_leaves, got_leaves = jax.tree.leaves(params), jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves) == 11
    for w, g in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_mamba2_forward_train_logits_match(mamba2):
    jcfg, tcfg, params, batch = mamba2
    want, _ = jlm.forward_train(params, batch, jcfg)
    got, _ = tlm.forward_train(bridge.params_from_numpy(params, tcfg),
                               _tbatch(batch), tcfg)
    _rel_close(got.detach().numpy(), want)


@pytest.mark.parametrize("depth", jspb.snapped_depths(
    j_reduced("mamba2-2.7b"), JSPB(mode="temporal", k=4)))
def test_mamba2_suffix_grads_match_and_prefix_is_zero(mamba2, depth):
    jcfg = mamba2[0]
    jg, tp = _suffix_grads(mamba2, depth)
    b = jcfg.num_layers - depth
    for w, p in zip(jax.tree.leaves(jg["groups"]),
                    jax.tree.leaves(tp["groups"])):
        w = np.asarray(w)
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g[:b]).max(initial=0.0) == 0.0
        _rel_close(g[b:], w[b:])
    for key in ("embed", "final_norm"):
        for w, p in zip(jax.tree.leaves(jg[key]), jax.tree.leaves(tp[key])):
            got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            _rel_close(got, w)


# ---------------------------------------------------------------------------
# recurrentgemma-reduced: (rglru, rglru, local) x 2, kernels on (their
# plain versions here), at the SSD suite's 1e-5: f32 layers whose scans and
# attention run the same math summed in another order
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recurrentgemma():
    jcfg = dataclasses.replace(j_reduced("recurrentgemma-2b"), use_pallas=True)
    tcfg = dataclasses.replace(t_reduced("recurrentgemma-2b"), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(3), jcfg))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, tcfg, params, {"tokens": tokens, "labels": labels}


def test_recurrentgemma_leaf_dtypes_equal_jax_at_bf16():
    """At bf16 the RG-LRU's lam, ba and bx stay f32, in the layout, in the
    port's init and through the bridge."""
    jcfg = j_reduced("recurrentgemma-2b").scaled(dtype="bfloat16")
    tcfg = t_reduced("recurrentgemma-2b").scaled(dtype="bfloat16")
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg), jax.random.key(0))
    shapes = tlm.param_shapes(tcfg)
    tdt = lambda t: str(t.dtype).removeprefix("torch.")
    for w, s in zip(jax.tree.leaves(want), jax.tree.leaves(shapes)):
        assert (tuple(w.shape), str(w.dtype)) == (tuple(s.shape), tdt(s))
    init = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    for s, t in zip(jax.tree.leaves(shapes), jax.tree.leaves(init)):
        assert (t.shape, t.dtype) == (s.shape, s.dtype)
    mixer = want["groups"][0][0]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype == jnp.float32} == \
        {"lam", "ba", "bx"}
    numpy_tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), want)
    bridged = bridge.params_from_numpy(numpy_tree, tcfg)
    for w, t in zip(jax.tree.leaves(want), jax.tree.leaves(bridged)):
        assert tdt(t) == str(w.dtype)


def test_recurrentgemma_init_follows_jax_rules():
    tcfg = t_reduced("recurrentgemma-2b")
    p = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
    m = p["groups"][0][0]["mixer"]
    u = torch.sqrt(torch.sigmoid(m["lam"]))     # lam = logit(u^2)
    assert float(u.min()) >= 0.9 - 1e-6 and float(u.max()) <= 0.999 + 1e-6
    for name in ("ba", "bx", "conv_b"):
        assert bool((m[name] == 0).all())
    assert abs(float(m["conv_w"].std()) * 2.0 - 1.0) < 0.1     # 1/sqrt(4)
    assert abs(float(m["wa"].std()) * 8.0 - 0.88) < 0.1   # trunc N / sqrt(64)


def test_recurrentgemma_bridge_copies_every_leaf(recurrentgemma):
    _, tcfg, params, _ = recurrentgemma
    got = bridge.params_from_numpy(params, tcfg)
    want_leaves, got_leaves = jax.tree.leaves(params), jax.tree.leaves(got)
    # one stacked group: tok + final_norm + 2 x 15 RG-LRU layer leaves
    # (two norms, ten mixer, three FFN) + 9 local-attention layer leaves
    assert len(got_leaves) == len(want_leaves) == 41
    for w, g in zip(want_leaves, got_leaves):
        np.testing.assert_array_equal(g.detach().numpy(), w)


def test_recurrentgemma_forward_train_logits_match(recurrentgemma):
    jcfg, tcfg, params, batch = recurrentgemma
    want, _ = jlm.forward_train(params, batch, jcfg)
    got, _ = tlm.forward_train(bridge.params_from_numpy(params, tcfg),
                               _tbatch(batch), tcfg)
    _rel_close(got.detach().numpy(), want)


@pytest.mark.parametrize("depth", jspb.snapped_depths(
    j_reduced("recurrentgemma-2b"), JSPB(mode="temporal", k=4)))
def test_recurrentgemma_suffix_grads_match_and_prefix_is_zero(
        recurrentgemma, depth):
    jcfg = recurrentgemma[0]
    jg, tp = _suffix_grads(recurrentgemma, depth)
    b = (jcfg.num_layers - depth) // len(jcfg.pattern)   # frozen units
    for w, p in zip(jax.tree.leaves(jg["groups"]),
                    jax.tree.leaves(tp["groups"])):
        w = np.asarray(w)
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g[:b]).max(initial=0.0) == 0.0
        _rel_close(g[b:], w[b:])
    for key in ("embed", "final_norm"):
        for w, p in zip(jax.tree.leaves(jg[key]), jax.tree.leaves(tp[key])):
            got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            _rel_close(got, w)


# ---------------------------------------------------------------------------
# gemma3-reduced ((local x 3, attn) x 2), deepseek-67b-reduced (untied
# embeddings) and qwen3-moe-reduced (every FFN an MoE layer), kernels on
# (their plain versions here), at the yi-6b tolerance; the MoE aux of the
# frozen layers counts in the loss at every depth
# ---------------------------------------------------------------------------

NEW_ARCHS = ("gemma3-4b", "deepseek-67b", "qwen3-moe-235b-a22b")


def _arch_setup(arch):
    jcfg = dataclasses.replace(j_reduced(arch), use_pallas=True)
    tcfg = dataclasses.replace(t_reduced(arch), use_pallas=True)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    return jcfg, tcfg, params, {"tokens": tokens, "labels": labels}


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch_setup(request):
    return _arch_setup(request.param)


def test_new_arch_bridge_logits_loss_and_aux_match(arch_setup):
    jcfg, tcfg, params, batch = arch_setup
    tp = bridge.params_from_numpy(params, tcfg)
    for w, g in zip(jax.tree.leaves(params), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(g.detach().numpy(), w)
    want, waux = jlm.forward_train(params, batch, jcfg)
    got, aux = tlm.forward_train(tp, _tbatch(batch), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(waux), **TOL)
    _, wm = jlm.loss_fn(params, batch, jcfg)
    _, tm = tlm.loss_fn(tp, _tbatch(batch), tcfg)
    for k in ("loss", "xent", "moe_aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(wm[k]),
                                   **TOL)
    assert (float(waux) > 0) == (jcfg.moe is not None)


@pytest.mark.parametrize("arch,depth", [
    (a, d) for a in NEW_ARCHS for d in sorted(set(jspb.snapped_depths(
        j_reduced(a), JSPB(mode="temporal", k=4))))])
def test_new_arch_suffix_grads_match_and_prefix_is_zero(arch, depth):
    """Suffix gradients at every snapped depth, zero in the frozen rows; the
    loss (the MoE aux of the frozen layers included, with no gradient into
    their routers) equals the reference's."""
    jcfg, tcfg, params, batch = _arch_setup(arch)
    (wloss, wm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batch, jcfg, bwd_layers=depth),
        has_aux=True)(params)
    tp = bridge.params_from_numpy(params, tcfg)
    loss, tm = tlm.loss_fn(tp, _tbatch(batch), tcfg, bwd_layers=depth)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(wloss), **TOL)
    np.testing.assert_allclose(float(tm["moe_aux"].detach()),
                               float(wm["moe_aux"]), **TOL)
    b = (jcfg.num_layers - depth) // len(jcfg.pattern)   # frozen units
    for w, p in zip(jax.tree.leaves(jg["groups"]),
                    jax.tree.leaves(tp["groups"])):
        w = np.asarray(w)
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.abs(g[:b]).max(initial=0.0) == 0.0
        np.testing.assert_allclose(g[b:], w[b:], **TOL)
    for key in ("embed", "final_norm"):
        for w, p in zip(jax.tree.leaves(jg[key]), jax.tree.leaves(tp[key])):
            got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            np.testing.assert_allclose(got, np.asarray(w), **TOL)


def test_qwen3_loss_at_depth_1_counts_the_frozen_layers_aux():
    """At depth 1 the three frozen MoE layers' aux stays in the loss: the
    aux equals the full-depth aux, and the loss is xent + 0.01 * aux as the
    reference's; the frozen routers get no gradient."""
    jcfg, tcfg, params, batch = _arch_setup("qwen3-moe-235b-a22b")
    tp = bridge.params_from_numpy(params, tcfg)
    loss, tm = tlm.loss_fn(tp, _tbatch(batch), tcfg, bwd_layers=1)
    _, full = tlm.loss_fn(bridge.params_from_numpy(params, tcfg),
                          _tbatch(batch), tcfg)
    wloss, wm = jlm.loss_fn(params, batch, jcfg, bwd_layers=1)
    np.testing.assert_allclose(float(loss.detach()), float(wloss), **TOL)
    np.testing.assert_allclose(float(tm["moe_aux"].detach()),
                               float(wm["moe_aux"]), **TOL)
    aux = float(tm["moe_aux"].detach())
    assert aux == float(full["moe_aux"].detach())
    assert aux > 3.0              # four layers' aux, each about 1 or more
    np.testing.assert_allclose(float(loss.detach()),
                               float(tm["xent"].detach()) + 0.01 * aux,
                               rtol=1e-6)
    loss.backward()
    router = tp["groups"][0][0]["ffn"]["router"].grad
    assert float(router[:3].abs().max()) == 0.0
    assert float(router[3].abs().max()) > 0.0


# ---------------------------------------------------------------------------
# The MLA archs: deepseek-v2-lite-reduced (dense layer 0, then MoE layers
# with a shared expert) and minicpm3-reduced (q-lora).  The reference runs
# MLA on its blockwise attention whatever use_pallas says; the port takes
# the kernels' padded route under use_pallas (their plain versions here)
# and the blockwise path without: both against the one reference gradient.
# ---------------------------------------------------------------------------

MLA_ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b")


def test_mla_arch_init_and_bridge():
    """kv_norm and q_norm are norms (zeros in the port's init, as
    init_rms_norm makes them); every leaf bridges, with the reference's
    shapes and dtypes."""
    for arch in MLA_ARCHS:
        tcfg = t_reduced(arch)
        p = tlm.init_lm(torch.Generator().manual_seed(0), tcfg)
        for g in p["groups"]:
            m = g[0]["mixer"]
            assert bool((m["kv_norm"] == 0).all())
            assert ("q_norm" in m) == bool(tcfg.mla.q_lora_rank)
            if "q_norm" in m:
                assert bool((m["q_norm"] == 0).all())
            assert float(m["wdkv"].std()) > 0
        jcfg = j_reduced(arch)
        want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg),
                              jax.random.key(0))
        for w, t in zip(jax.tree.leaves(want),
                        jax.tree.leaves(tlm.param_shapes(tcfg))):
            assert (tuple(w.shape), str(w.dtype)) == \
                (tuple(t.shape), str(t.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch,depth", [
    (a, d) for a in MLA_ARCHS for d in sorted(set(jspb.snapped_depths(
        j_reduced(a), JSPB(mode="temporal", k=4))))])
def test_mla_arch_loss_and_suffix_grads_match(arch, depth):
    """Loss, aux and suffix gradients at every snapped depth, zero in the
    frozen rows, with use_pallas on and off."""
    jcfg, _, params, batch = _arch_setup(arch)
    (wloss, wm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, batch, jcfg, bwd_layers=depth),
        has_aux=True)(params)
    for use_pallas in (True, False):
        tcfg = dataclasses.replace(t_reduced(arch), use_pallas=use_pallas)
        tp = bridge.params_from_numpy(params, tcfg)
        loss, tm = tlm.loss_fn(tp, _tbatch(batch), tcfg, bwd_layers=depth)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(wloss), **TOL)
        np.testing.assert_allclose(float(tm["moe_aux"].detach()),
                                   float(wm["moe_aux"]), **TOL)
        frozen = jcfg.num_layers - depth         # one layer a unit
        off = 0
        for (unit, count), jgg, tgg in zip(
                jc_layer_groups(jcfg), jg["groups"], tp["groups"]):
            b = min(max(frozen - off, 0), count)
            off += count
            for w, p in zip(jax.tree.leaves(jgg), jax.tree.leaves(tgg)):
                w = np.asarray(w)
                g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
                assert np.abs(g[:b]).max(initial=0.0) == 0.0
                np.testing.assert_allclose(g[b:], w[b:], **TOL)
        for key in ("embed", "final_norm"):
            for w, p in zip(jax.tree.leaves(jg[key]),
                            jax.tree.leaves(tp[key])):
                got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
                np.testing.assert_allclose(got, np.asarray(w), **TOL)
