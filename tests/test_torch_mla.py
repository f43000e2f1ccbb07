"""The port's MLA layer against the JAX package's: ``mla_fwd`` and its
gradients for both query forms (deepseek-v2-lite-reduced: no q-lora;
minicpm3-reduced: q-lora 48), with the kernels' padded route (their plain
versions here) and without; the absorbed-matrix ``mla_decode``; the plain
``blockwise_attention`` at a V head dim (16) other than the q/k one (24);
and the padded, explicit-scale route of ``ops.flash_attention`` against
the unpadded attention.

Tolerance 1e-5 (the repo's f32 kernel-gradient tolerance), on
max|got - want| / max(max|want|, 1): the same f32 math summed in another
order."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import layers as jL
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import layers as tL

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

MLA_ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b")
TOL = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max(initial=0.0) / max(
        np.abs(want).max(initial=0.0), 1.0)
    assert err <= tol, f"rel err {err:.3e} > {tol:g}"


def _layer(arch, seed=0, B=2, S=64):
    j = j_reduced(arch)
    p = jax.tree.map(np.asarray, jL.init_mla(jax.random.key(seed), j,
                                            jnp.float32))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, j.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, j.d_model)).astype(np.float32)
    return j, p, x, g


def test_mla_shapes_equal_init_mla():
    for arch in MLA_ARCHS:
        j = j_reduced(arch)
        want = jax.eval_shape(lambda k: jL.init_mla(k, j, jnp.float32),
                              jax.random.key(0))
        got = tL.mla_shapes(t_reduced(arch), torch.float32)
        assert {k: tuple(v.shape) for k, v in want.items()} == \
            {k: v[0] for k, v in got.items()}
        assert ("wq" in got) == (j.mla.q_lora_rank is None)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_fwd_and_grads_match(arch, use_pallas):
    j, p, x, g = _layer(arch)
    pos = np.arange(x.shape[1])

    def jloss(pp, xx):
        out = jL.mla_fwd(pp, xx, j, positions=jnp.asarray(pos))
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, x)
    cfg = dataclasses.replace(t_reduced(arch), use_pallas=use_pallas)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = tL.mla_fwd(tp, tx, cfg, positions=torch.arange(x.shape[1]))
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, jout)
    _close(tx.grad, jgx)
    assert set(tp) == set(jgp)
    for k in tp:
        _close(tp[k].grad, jgp[k])
    assert float(tp["kv_norm"].grad.abs().max()) > 0


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_mla_prefill_and_absorbed_decode_match(arch):
    """Prefill S - 1 tokens into the latent cache, then one absorbed-matrix
    decode step: the same output and caches as the reference's."""
    j, p, x, _ = _layer(arch, seed=1, B=2, S=32)
    S = x.shape[1]
    jc = jL.init_mla_cache(j, 2, S, jnp.float32)
    jo1, jc = jL.mla_prefill(p, x[:, :-1], j, positions=jnp.arange(S - 1),
                             cache=jc)
    jo2, jc = jL.mla_decode(p, x[:, -1:], j, pos=jnp.asarray(S - 1), cache=jc)
    cfg = t_reduced(arch)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tx = torch.tensor(x)
    tc = tL.init_mla_cache(cfg, 2, S, torch.float32)
    o1, tc = tL.mla_prefill(tp, tx[:, :-1], cfg,
                            positions=torch.arange(S - 1), cache=tc)
    o2, tc = tL.mla_decode(tp, tx[:, -1:], cfg, pos=torch.tensor(S - 1),
                           cache=tc)
    _close(o1, jo1)
    _close(o2, jo2)
    for k in ("ckv", "kr"):
        _close(tc[k], jc[k])
    # the absorbed decode of the last token equals the materialized form
    full = tL.mla_fwd(tp, tx, cfg, positions=torch.arange(S))
    _close(o2[:, 0], full[:, -1])


def _qkv(seed=0, B=2, S=64, H=4, dqk=24, dv=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, d)).astype(np.float32)
            for d in (dqk, dqk, dv)]


def test_blockwise_attention_with_other_v_head_dim_matches():
    q, k, v = _qkv()
    for qb in (64, 16):             # one q block, and four
        want = jL.blockwise_attention(q, k, v, causal=True, q_block=qb,
                                      kv_block=qb)
        got = tL.blockwise_attention(*map(torch.tensor, (q, k, v)),
                                     causal=True, q_block=qb, kv_block=qb)
        assert tuple(got.shape) == (2, 64, 4, 16)
        _close(got, want)


def test_padded_head_dims():
    assert [fa.padded_head_dim(n) for n in (16, 24, 96, 128, 192, 256)] == \
        [16, 32, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="head_dim"):
        fa.padded_head_dim(257)


def test_padded_explicit_scale_route_matches_unpadded_attention():
    """Q, K, V zero-padded from (24, 24, 16) to 32 through
    ``ops.flash_attention`` with scale 1 / sqrt(24), cut back to 16: the
    unpadded attention's output and gradients."""
    q, k, v = _qkv(seed=3)
    dqk, dv, D = 24, 16, 32
    g = np.random.default_rng(4).standard_normal(
        (2, 64, 4, dv)).astype(np.float32)
    want = jL.blockwise_attention(q, k, v, causal=True)

    def leaves():
        return [torch.tensor(t, requires_grad=True) for t in (q, k, v)]

    tq, tk, tv = leaves()
    pad = lambda t: torch.nn.functional.pad(t, (0, D - t.shape[-1]))
    out = ops.flash_attention(pad(tq), pad(tk), pad(tv), causal=True,
                              scale=1.0 / math.sqrt(dqk))[..., :dv]
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, want)
    rq, rk, rv = leaves()
    ref = tL.blockwise_attention(rq, rk, rv, causal=True)
    (ref * torch.from_numpy(g)).sum().backward()
    _close(out, ref.detach())
    for a, b in ((tq, rq), (tk, rk), (tv, rv)):
        _close(a.grad, b.grad)
    # without the explicit scale the padded route scales by 1 / sqrt(32)
    off = ops.flash_attention(pad(tq), pad(tk), pad(tv))[..., :dv]
    assert float((off - ref).detach().abs().max()) > 1e-3
