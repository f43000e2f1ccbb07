"""The port's dense layers against the JAX package's on yi-6b-reduced
shapes in f32: values and gradients from the same numpy inputs.

Tolerances: 1e-5 for the elementwise layers and the projections (the
same f32 operations, reduced in another order); 2e-4 for anything that
goes through attention, the repo's flash-attention tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import layers as JL
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(fn_j, fn_t, args, ct, tol=TOL, argnums=None):
    """Values and gradients of sum(fn(*args) * ct) in both packages."""
    argnums = tuple(range(len(args))) if argnums is None else argnums
    out_j = fn_j(*args)
    grads_j = jax.grad(lambda *a: jnp.sum(fn_j(*a) * ct),
                       argnums=argnums)(*args)
    ts = [torch.tensor(a, requires_grad=i in argnums)
          for i, a in enumerate(args)]
    out_t = fn_t(*ts)
    (out_t * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **tol)
    for i, g in zip(argnums, grads_j):
        np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(g), **tol,
                                   err_msg=f"grad of argument {i}")


def test_rms_norm_values_and_grads():
    rng = np.random.default_rng(0)
    x, w, ct = _rand(rng, 2, 8, 64), _rand(rng, 64, scale=0.1), \
        _rand(rng, 2, 8, 64)
    _check(lambda x, w: JL.rms_norm(x, w, 1e-6),
           lambda x, w: TL.rms_norm(x, w, 1e-6), (x, w), ct)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(batched_positions):
    rng = np.random.default_rng(1)
    x, ct = _rand(rng, 2, 8, 4, 16), _rand(rng, 2, 8, 4, 16)
    pos = (rng.integers(0, 100, (2, 8)) if batched_positions
           else np.arange(8)).astype(np.int32)
    _check(lambda x: JL.rope(x, jnp.asarray(pos), 10000.0),
           lambda x: TL.rope(x, torch.from_numpy(pos), 10000.0), (x,), ct)


def test_embed_unembed():
    jcfg, tcfg = j_reduced("yi-6b"), t_reduced("yi-6b")
    rng = np.random.default_rng(2)
    tok = _rand(rng, jcfg.padded_vocab, jcfg.d_model, scale=0.02)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ct = _rand(rng, 2, 8, jcfg.padded_vocab)
    _check(lambda t: JL.unembed({"tok": t}, JL.embed({"tok": t}, tokens,
                                                     jcfg), jcfg),
           lambda t: TL.unembed({"tok": t}, TL.embed(
               {"tok": t}, torch.from_numpy(tokens).long(), tcfg), tcfg),
           (tok,), ct)


@pytest.mark.parametrize("valid_vocab", [None, 500])
def test_softmax_xent_values_and_grads(valid_vocab):
    rng = np.random.default_rng(3)
    logits = _rand(rng, 2, 8, 512, scale=3.0)
    labels = rng.integers(0, valid_vocab or 512, (2, 8)).astype(np.int32)
    jl = jnp.asarray(labels)
    tl = torch.from_numpy(labels)
    _check(lambda x: JL.softmax_xent(x, jl, valid_vocab),
           lambda x: TL.softmax_xent(x, tl, valid_vocab), (logits,),
           np.array(1.0, np.float32))


def test_ffn_values_and_grads():
    rng = np.random.default_rng(4)
    x, ct = _rand(rng, 2, 8, 64), _rand(rng, 2, 8, 64)
    wg, wu = _rand(rng, 64, 128, scale=0.1), _rand(rng, 64, 128, scale=0.1)
    wd = _rand(rng, 128, 64, scale=0.1)
    _check(lambda x, g, u, d: JL.ffn_fwd({"wg": g, "wu": u, "wd": d}, x),
           lambda x, g, u, d: TL.ffn_fwd({"wg": g, "wu": u, "wd": d}, x),
           (x, wg, wu, wd), ct)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_fwd_values_and_grads(use_pallas):
    jcfg = dataclasses.replace(j_reduced("yi-6b"), use_pallas=use_pallas)
    tcfg = dataclasses.replace(t_reduced("yi-6b"), use_pallas=use_pallas)
    rng = np.random.default_rng(5)
    x, ct = _rand(rng, 2, 64, 64), _rand(rng, 2, 64, 64)
    w = [_rand(rng, 64, 64, scale=0.2), _rand(rng, 64, 32, scale=0.2),
         _rand(rng, 64, 32, scale=0.2), _rand(rng, 64, 64, scale=0.2)]
    names = ("wq", "wk", "wv", "wo")
    pos = np.arange(64, dtype=np.int32)

    def fj(x, *w):
        return JL.attention_fwd(dict(zip(names, w)), x, jcfg, kind="attn",
                                positions=jnp.asarray(pos))

    def ft(x, *w):
        return TL.attention_fwd(dict(zip(names, w)), x, tcfg, kind="attn",
                                positions=torch.from_numpy(pos))

    _check(fj, ft, (x, *w), ct, tol=ATTN_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_blockwise_attention_matches(window):
    rng = np.random.default_rng(6)
    q, ct = _rand(rng, 1, 96, 4, 16), _rand(rng, 1, 96, 4, 16)
    k, v = _rand(rng, 1, 96, 2, 16), _rand(rng, 1, 96, 2, 16)
    kw = dict(causal=True, window=window, q_block=32, kv_block=32)
    _check(lambda q, k, v: JL.blockwise_attention(q, k, v, **kw),
           lambda q, k, v: TL.blockwise_attention(q, k, v, **kw),
           (q, k, v), ct, tol=ATTN_TOL)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_pallas_gate_falls_back_on_untiled_sequences(monkeypatch, device):
    """On the CPU, as the JAX shape gate: S % min(128, S) != 0 takes the
    blockwise path, a tiling S the kernels' plain versions.  On the card
    every S takes the kernels (they tile at 64 and mask ragged edges):
    nothing there falls back to the plain path."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(7)
    for S in (200, 256):
        q = torch.from_numpy(_rand(rng, 1, S, 4, 16)).to(device)
        k = torch.from_numpy(_rand(rng, 1, S, 2, 16)).to(device)
        out = TL._pallas_attention(q, k, k, causal=True, window=0)
        assert (out is None) == (device == "cpu" and S == 200)
    assert len(calls) == (1 if device == "cpu" else 2)
