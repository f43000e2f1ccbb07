"""The port's LM on weights bridged from the JAX package: the bridge is a
checked name-by-name copy, the logits match, and SPB partial backprop
gives JAX's suffix gradients with a zero (or absent) prefix gradient.

Tolerance 2e-4: four f32 layers whose attention goes through the kernels'
plain versions on one side and the Pallas kernels (interpret mode) on the
other, the repo's flash-attention tolerance."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB
from repro.configs import reduced_config as j_reduced
from repro.core import spb as jspb
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import lm as tlm

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
