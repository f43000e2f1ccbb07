"""The port's dense-cache serving path (``lm.prefill`` + ``lm.decode_step``)
for every registered arch, mirroring tests/test_decode_consistency.py:
prefill plus a one-token decode reproduce the train forward's next-token
logits (with the kernels' plain versions and without), a greedy
multi-token decode equals the teacher-forced forward, a local layer's ring
buffer survives decoding far past its window, and the port's prefill and
decode logits equal the reference's on bridged weights.  An
encoder-decoder's batch carries seeded ``frames`` for its encoder (its
``cross`` caches hold their K/V); a frontend config's carries seeded
``frontend`` embeddings before S - frontend_tokens text positions.

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

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _setup(arch, seed=0, B=2, S=64, use_pallas=True):
    """Configs, numpy params and a numpy batch of S positions in all:
    tokens, plus frames (B, S, d) or frontend (B, frontend_tokens, d)."""
    jcfg = j_reduced(arch)
    tcfg = dataclasses.replace(t_reduced(arch), use_pallas=use_pallas)
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed)
    batch = {}
    if jcfg.enc_layers:
        batch["frames"] = rng.normal(size=(B, S, jcfg.d_model))
    elif jcfg.frontend:
        batch["frontend"] = rng.normal(size=(B, jcfg.frontend_tokens,
                                             jcfg.d_model))
        S -= jcfg.frontend_tokens
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    batch["tokens"] = rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)
    return jcfg, tcfg, params, batch


def _enc_len(cfg, batch):
    return batch["frames"].shape[1] if cfg.enc_layers else 0


def _positions(batch):
    """All the positions a batch fills: its text and frontend tokens."""
    return batch["tokens"].shape[1] + (batch["frontend"].shape[1]
                                       if "frontend" in batch else 0)


def _tb(batch, stop=None):
    """The batch as torch tensors, its tokens cut to [:stop]."""
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"][:, :stop].long()
    return out


def _jb(batch, stop=None):
    return dict(batch, tokens=batch["tokens"][:, :stop])


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode_matches_forward(arch, use_pallas):
    _, tcfg, params, batch = _setup(arch, use_pallas=use_pallas)
    B, S = batch["tokens"].shape[0], _positions(batch)
    tp = bridge.params_from_numpy(params, tcfg)
    t = _tb(batch)["tokens"]
    with torch.no_grad():
        logits_train, _ = tlm.forward_train(tp, _tb(batch), tcfg)
    cache = tlm.init_cache(tcfg, B, S, _enc_len(tcfg, batch))
    logits_pre, cache = tlm.prefill(tp, _tb(batch, -1), tcfg, cache)
    logits_dec, cache = tlm.decode_step(tp, cache, t[:, -1:], tcfg)
    assert int(cache["pos"]) == S
    np.testing.assert_allclose(_np(logits_pre[:, 0]),
                               _np(logits_train[:, -2]), **TOL)
    np.testing.assert_allclose(_np(logits_dec[:, 0]),
                               _np(logits_train[:, -1]), **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_logits_equal_the_reference(arch):
    jcfg, tcfg, params, batch = _setup(arch, seed=1)
    B, S, T = batch["tokens"].shape[0], _positions(batch), \
        _enc_len(jcfg, batch)
    toks = batch["tokens"]
    jc = jlm.init_cache(jcfg, B, S, enc_len=T)
    jpre, jc = jlm.prefill(params, _jb(batch, -1), jcfg, jc)
    jdec, jc = jlm.decode_step(params, jc, toks[:, -1:], jcfg)
    tp = bridge.params_from_numpy(params, tcfg)
    t = _tb(batch)["tokens"]
    cache = tlm.init_cache(tcfg, B, S, T)
    pre, cache = tlm.prefill(tp, _tb(batch, -1), tcfg, cache)
    dec, cache = tlm.decode_step(tp, cache, t[:, -1:], tcfg)
    np.testing.assert_allclose(_np(pre), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(jdec), **TOL)
    # the caches (an xdec layer's cross K/V among them), leaf by leaf, in
    # the reference's grouped layout
    shapes = tlm.cache_shapes(tcfg, B, S, T)
    for w, g, s in zip(jax.tree.leaves(jc["groups"]),
                       jax.tree.leaves(cache["groups"]),
                       jax.tree.leaves(shapes["groups"])):
        assert tuple(g.shape) == tuple(s.shape) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ["gemma3-4b", "yi-6b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "minicpm3-4b",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium", "internvl2-26b"])
def test_multi_step_decode_matches_forward(arch):
    """Greedy multi-token decode equals teacher-forced forward logits (the
    text positions', after a frontend)."""
    _, tcfg, params, batch = _setup(arch, seed=1, B=1, S=48)
    S, gen = batch["tokens"].shape[1], 8
    tp = bridge.params_from_numpy(params, tcfg)
    t = _tb(batch)["tokens"]
    with torch.no_grad():
        logits_train, _ = tlm.forward_train(tp, _tb(batch), tcfg)
    cache = tlm.init_cache(tcfg, 1, _positions(batch), _enc_len(tcfg, batch))
    _, cache = tlm.prefill(tp, _tb(batch, S - gen), tcfg, cache)
    for i in range(gen):
        pos = S - gen + i
        logits, cache = tlm.decode_step(tp, cache, t[:, pos:pos + 1], tcfg)
        np.testing.assert_allclose(_np(logits[:, 0]),
                                   _np(logits_train[:, pos]), **TOL)


def test_local_ring_buffer_eviction():
    """Decode far past the window: the ring buffer holds exactly the last W
    positions and the output stays equal to the train path."""
    _, tcfg, params, batch = _setup("gemma3-4b", seed=2, B=1, S=96)
    W = tcfg.window                               # 32: S = 3 W
    S = 3 * W
    tp = bridge.params_from_numpy(params, tcfg)
    t = _tb(batch)["tokens"]
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
        j = jlm.cache_shapes(j_reduced(arch), 2, 40, enc_len=24)
        t = tlm.cache_shapes(t_reduced(arch), 2, 40, 24)
        assert [w.shape for w in jax.tree.leaves(j["groups"])] == \
            [tuple(s.shape) for s in jax.tree.leaves(t["groups"])]
        assert [str(w.dtype) for w in jax.tree.leaves(j["groups"])] == \
            [str(s.dtype).removeprefix("torch.")
             for s in jax.tree.leaves(t["groups"])]
