"""The port's dense-cache serving path (``lm.prefill`` + ``lm.decode_step``)
for every registered arch, mirroring tests/test_decode_consistency.py:
prefill plus a one-token decode reproduce the train forward's next-token
logits (with the kernels' plain versions and without), a greedy
multi-token decode equals the teacher-forced forward, a local layer's ring
buffer survives decoding far past its window, and the port's prefill and
decode logits equal the reference's on bridged weights.

Tolerance 2e-4, the reference's (3e-4 for the ring buffer)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.configs import ARCHS
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import lm as tlm

TOL = dict(rtol=2e-4, atol=2e-4)


def _setup(arch, seed=0, B=2, S=64, use_pallas=True):
    jcfg = j_reduced(arch)
    tcfg = dataclasses.replace(t_reduced(arch), use_pallas=use_pallas)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), jcfg))
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, toks


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_matches_forward(arch, use_pallas):
    _, tcfg, params, toks = _setup(arch, use_pallas=use_pallas)
    B, S = toks.shape
    tp = bridge.params_from_numpy(params, tcfg)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits_train, _ = tlm.forward_train(tp, {"tokens": t}, tcfg)
    cache = tlm.init_cache(tcfg, B, S)
    logits_pre, cache = tlm.prefill(tp, {"tokens": t[:, :-1]}, tcfg, cache)
    logits_dec, cache = tlm.decode_step(tp, cache, t[:, -1:], tcfg)
    assert int(cache["pos"]) == S
    np.testing.assert_allclose(_np(logits_pre[:, 0]),
                               _np(logits_train[:, -2]), **TOL)
    np.testing.assert_allclose(_np(logits_dec[:, 0]),
                               _np(logits_train[:, -1]), **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_logits_equal_the_reference(arch):
    jcfg, tcfg, params, toks = _setup(arch, seed=1)
    B, S = toks.shape
    jc = jlm.init_cache(jcfg, B, S)
    jpre, jc = jlm.prefill(params, {"tokens": toks[:, :-1]}, jcfg, jc)
    jdec, jc = jlm.decode_step(params, jc, toks[:, -1:], jcfg)
    tp = bridge.params_from_numpy(params, tcfg)
    t = torch.from_numpy(toks).long()
    cache = tlm.init_cache(tcfg, B, S)
    pre, cache = tlm.prefill(tp, {"tokens": t[:, :-1]}, tcfg, cache)
    dec, cache = tlm.decode_step(tp, cache, t[:, -1:], tcfg)
    np.testing.assert_allclose(_np(pre), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(jdec), **TOL)
    # the caches, leaf by leaf, in the reference's grouped layout
    shapes = tlm.cache_shapes(tcfg, B, S)
    for w, g, s in zip(jax.tree.leaves(jc["groups"]),
                       jax.tree.leaves(cache["groups"]),
                       jax.tree.leaves(shapes["groups"])):
        assert tuple(g.shape) == tuple(s.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ["gemma3-4b", "yi-6b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "minicpm3-4b",
                                  "deepseek-v2-lite-16b"])
def test_multi_step_decode_matches_forward(arch):
    """Greedy multi-token decode equals teacher-forced forward logits."""
    _, tcfg, params, toks = _setup(arch, seed=1, B=1, S=48)
    S, gen = 48, 8
    tp = bridge.params_from_numpy(params, tcfg)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits_train, _ = tlm.forward_train(tp, {"tokens": t}, tcfg)
    cache = tlm.init_cache(tcfg, 1, S)
    _, cache = tlm.prefill(tp, {"tokens": t[:, :S - gen]}, tcfg, cache)
    for i in range(gen):
        pos = S - gen + i
        logits, cache = tlm.decode_step(tp, cache, t[:, pos:pos + 1], tcfg)
        np.testing.assert_allclose(_np(logits[:, 0]),
                                   _np(logits_train[:, pos]), **TOL)


def test_local_ring_buffer_eviction():
    """Decode far past the window: the ring buffer holds exactly the last W
    positions and the output stays equal to the train path."""
    _, tcfg, params, toks = _setup("gemma3-4b", seed=2, B=1, S=96)
    W = tcfg.window                               # 32: S = 3 W
    S = 3 * W
    tp = bridge.params_from_numpy(params, tcfg)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits_train, _ = tlm.forward_train(tp, {"tokens": t}, tcfg)
    cache = tlm.init_cache(tcfg, 1, S)
    local = cache["groups"][0][0]["self"]["k"]
    assert local.shape[2] == W                    # the ring, not S
    _, cache = tlm.prefill(tp, {"tokens": t[:, :S // 2]}, tcfg, cache)
    for pos in range(S // 2, S):
        logits, cache = tlm.decode_step(tp, cache, t[:, pos:pos + 1], tcfg)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(logits_train[:, -1]),
                               rtol=3e-4, atol=3e-4)


def test_cache_shapes_equal_the_reference():
    for arch in sorted(ARCHS):
        j = jlm.cache_shapes(j_reduced(arch), 2, 40)
        t = tlm.cache_shapes(t_reduced(arch), 2, 40)
        assert [w.shape for w in jax.tree.leaves(j["groups"])] == \
            [tuple(s.shape) for s in jax.tree.leaves(t["groups"])]
        assert [str(w.dtype) for w in jax.tree.leaves(j["groups"])] == \
            [str(s.dtype).removeprefix("torch.")
             for s in jax.tree.leaves(t["groups"])]
