"""The port's Mamba-2 block against the JAX package's on mamba2-reduced:
the causal conv (values and gradients), the plain chunked scan, and the
block with the SSD kernels on and off, from bridged weights.

Tolerances: 1e-5 relative (max|got - want| / max(max|want|, 1)) for f32,
the same f32 math summed in another order; 2e-2 for bf16 (8-bit
mantissas, rounded at other places by the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import ssm as tssm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

F32_TOL, BF16_TOL = 1e-5, 2e-2


def _rel_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, f"rel err {err:.3e} > {tol:g}"


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) / 2
    b = rng.standard_normal((24,)).astype(np.float32)
    g = rng.standard_normal((2, 37, 24)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jin = [jnp.asarray(t).astype(jdt) for t in (x, w, b)]
    want, vjp = jax.vjp(jssm.causal_conv, *jin)
    want_grads = vjp(jnp.asarray(g).astype(jdt))
    tin = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (x, w, b)]
    got = tssm.causal_conv(*tin)
    assert got.dtype == tdt
    got_grads = torch.autograd.grad(got, tin, torch.from_numpy(g).to(tdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _rel_close(_np(got), np.asarray(want.astype(jnp.float32)), tol)
    for gg, ww, t in zip(got_grads, want_grads, tin):
        assert gg.dtype == t.dtype
        _rel_close(_np(gg), np.asarray(ww.astype(jnp.float32)), tol)


def test_causal_conv_keeps_its_input_once():
    """Autograd holds x in its own dtype and the weights, no f32 copy."""
    x = torch.randn(2, 16, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(4, 8, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(8, dtype=torch.bfloat16, requires_grad=True)
    saved = tssm.causal_conv(x, w, b).grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.bfloat16, torch.bfloat16]
    assert saved[0].data_ptr() == x.data_ptr()


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (10, 32)])
def test_ssd_scan_matches_jax(S, chunk):
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 4, 5
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dA = -rng.uniform(0.05, 2.0, (B, S, H)).astype(np.float32)
    bm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, js = jssm._ssd_scan(*(jnp.asarray(t) for t in (x, dA, bm, cm, s0)),
                            chunk)
    ty, ts = tssm._ssd_scan(*(torch.from_numpy(t)
                              for t in (x, dA, bm, cm, s0)), chunk)
    _rel_close(_np(ty), jy, F32_TOL)
    _rel_close(_np(ts), js, F32_TOL)


@pytest.fixture(scope="module")
def reduced_mixer():
    """Layer 0's mixer weights of mamba2-reduced, from JAX's init."""
    jcfg = j_reduced("mamba2-2.7b")
    params = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(1), jcfg))
    return params


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("S", [64, 45])
def test_mamba2_fwd_matches_jax(reduced_mixer, use_pallas, S):
    jcfg = dataclasses.replace(j_reduced("mamba2-2.7b"), use_pallas=use_pallas)
    tcfg = dataclasses.replace(t_reduced("mamba2-2.7b"), use_pallas=use_pallas)
    assert tssm._use_pallas_ssd(tcfg, S, 16, 16) == use_pallas
    tp = bridge.params_from_numpy(reduced_mixer, tcfg)
    jp = jax.tree.map(lambda a: a[1], reduced_mixer["groups"][0][0]["mixer"])
    pt = {k: v[1] for k, v in tp["groups"][0][0]["mixer"].items()}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    g = rng.standard_normal((2, S, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jssm.mamba2_fwd(p, x, jcfg), jp,
                        jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tssm.mamba2_fwd(pt, xt, tcfg)
    _rel_close(_np(got), want, F32_TOL)
    names = sorted(pt)
    grads = torch.autograd.grad(got, [xt] + [pt[k] for k in names],
                                torch.from_numpy(g))
    _rel_close(_np(grads[0]), want_dx, F32_TOL)
    for name, gg in zip(names, grads[1:]):
        _rel_close(_np(gg), want_dp[name], F32_TOL)


@pytest.mark.parametrize("P,N,chunk,S", [
    (16, 16, 16, 64), (64, 128, 256, 600), (16, 32, 16, 64),
    (8, 8, 512, 600)])
def test_kernel_gate_follows_use_pallas(P, N, chunk, S):
    """As JAX's gate off the TPU: ``use_pallas`` alone decides, for any
    shape; a shape the card's kernels do not take raises there instead
    (tests/test_torch_kernels_cuda.py)."""
    cfg = t_reduced("mamba2-2.7b")
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=chunk))
    for use_pallas in (False, True):
        assert tssm._use_pallas_ssd(dataclasses.replace(
            cfg, use_pallas=use_pallas), S, P, N) is use_pallas

# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma-reduced)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (10, 32), (33, 4)])
def test_lru_scan_matches_jax(S, chunk):
    """The plain chunked scan (Hillis-Steele within a chunk) against JAX's
    associative_scan chunks, from a nonzero state, ragged tails
    included."""
    rng = np.random.default_rng(S + chunk)
    B, W = 2, 6
    a = rng.uniform(0.1, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    jh, jT = jssm._lru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                            chunk)
    th, tT = tssm._lru_scan(*(torch.from_numpy(t) for t in (a, b, h0)),
                            chunk)
    _rel_close(_np(th), jh, F32_TOL)
    _rel_close(_np(tT), jT, F32_TOL)


@pytest.fixture(scope="module")
def rglru_params():
    """recurrentgemma-reduced weights from JAX's init."""
    jcfg = j_reduced("recurrentgemma-2b")
    return jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(2), jcfg))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("S", [64, 45])
def test_rglru_fwd_matches_jax(rglru_params, use_pallas, S):
    """The RG-LRU block (gelu-tanh gate, f32 gate products, the scan, h
    rounded to x's dtype before the gate) and its gradients, kernels on
    (their plain versions here; Pallas in interpret mode on the JAX side)
    and off."""
    jcfg = dataclasses.replace(j_reduced("recurrentgemma-2b"),
                               use_pallas=use_pallas)
    tcfg = dataclasses.replace(t_reduced("recurrentgemma-2b"),
                               use_pallas=use_pallas)
    assert tssm._use_pallas_rglru(tcfg) == use_pallas
    tp = bridge.params_from_numpy(rglru_params, tcfg)
    jp = jax.tree.map(lambda a: a[1], rglru_params["groups"][0][1]["mixer"])
    pt = {k: v[1] for k, v in tp["groups"][0][1]["mixer"].items()}
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    g = rng.standard_normal((2, S, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jssm.rglru_fwd(p, x, jcfg), jp,
                        jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tssm.rglru_fwd(pt, xt, tcfg)
    _rel_close(_np(got), want, F32_TOL)
    names = sorted(pt)
    grads = torch.autograd.grad(got, [xt] + [pt[k] for k in names],
                                torch.from_numpy(g))
    _rel_close(_np(grads[0]), want_dx, F32_TOL)
    for name, gg in zip(names, grads[1:]):
        _rel_close(_np(gg), want_dp[name], F32_TOL)


def test_rglru_gate_follows_use_pallas():
    """``use_pallas`` alone picks the kernels, as JAX's gate off the TPU;
    on the card an input they do not take raises in their wrappers."""
    cfg = t_reduced("recurrentgemma-2b")
    for use_pallas in (False, True):
        assert tssm._use_pallas_rglru(dataclasses.replace(
            cfg, use_pallas=use_pallas)) is use_pallas
