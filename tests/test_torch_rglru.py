"""The port's RG-LRU scan on the CPU (the kernels' plain versions and the
autograd op) against the JAX Pallas kernels in interpret mode, the JAX op
and the sequential oracles.

Tolerance: the JAX suite's measure (tests/test_kernel_grads.py),
max|got - want| / max(max|want|, 1) <= 1e-5: the same f32 recurrence, one
step at a time on both sides.  Inputs: a ~ U(0.1, 0.999), b and the
cotangent ~ N(0, 1), as in that suite.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.analysis import rglru_tiles
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rglru
from repro_torch.kernels import rglru_bwd

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

# the package's __init__ binds ``rglru`` to the op, so reach the modules
jrglru = importlib.import_module("repro.kernels.rglru")
jrglru_bwd = importlib.import_module("repro.kernels.rglru_bwd")

TOL = 1e-5


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, f"rel err {err:.3e} > {tol:g}"


def _inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    dy = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b, dy


# (B, S, W, chunk, width_block) of the Pallas kernels, which need S and W
# to be whole multiples; the port's plain versions take any S
PALLAS = pytest.mark.parametrize("B,S,W,chunk,wb", [
    (2, 64, 16, 16, 16), (1, 40, 24, 8, 8), (2, 7, 3, 7, 3)])


@PALLAS
def test_scan_plain_matches_pallas_and_ref(B, S, W, chunk, wb):
    a, b, _ = _inputs(B, S, W, seed=S)
    want = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                             width_block=wb, interpret=True)
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), want)
    _rel_close(got.numpy(), jref.rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    _rel_close(ref.rglru_ref(torch.from_numpy(a), torch.from_numpy(b)),
               got.numpy())


@PALLAS
def test_bwd_plain_matches_pallas(B, S, W, chunk, wb):
    """The port's backward takes h itself; the Pallas kernel the shifted
    copy y_prev that JAX's op builds from it."""
    a, b, dy = _inputs(B, S, W, seed=S + 1)
    h = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                          width_block=wb, interpret=True)
    y_prev = jnp.pad(h, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    want = jrglru_bwd.bwd_kernel_layout(jnp.asarray(a), y_prev,
                                        jnp.asarray(dy), chunk=chunk,
                                        width_block=wb, interpret=True)
    got = rglru_bwd.bwd_kernel_layout(torch.from_numpy(a),
                                      torch.tensor(np.asarray(h)),
                                      torch.from_numpy(dy))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _rel_close(g.numpy(), w)


@pytest.mark.parametrize("S", [1, 33, 600])
def test_bwd_plain_matches_autodiff_of_the_oracle(S):
    """Ragged lengths included: da, db against autograd through the
    sequential oracle."""
    a, b, dy = _inputs(2, S, 8, seed=S + 2)
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    ref.rglru_ref(ta, tb).backward(torch.from_numpy(dy))
    h = rglru.rglru_plain(torch.from_numpy(a), torch.from_numpy(b))
    da, db = rglru_bwd.bwd_plain(torch.from_numpy(a), h, torch.from_numpy(dy))
    _rel_close(da.numpy(), ta.grad.numpy())
    _rel_close(db.numpy(), tb.grad.numpy())


@pytest.mark.parametrize("S,chunk", [(64, 16), (37, 16), (5, 16)])
def test_op_values_and_grads_match_jax(S, chunk):
    """ops.rglru against the JAX op (Pallas kernels in interpret mode,
    padded to whole chunks with a = 1, b = 0) on any S."""
    a, b, ct = _inputs(2, S, 12, seed=S + 3)

    def j_loss(a, b):
        h = jops.rglru(a, b, chunk=chunk, width_block=12, interpret=True)
        return jnp.sum(h * ct), h

    (_, want), want_grads = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    got = ops.rglru(ta, tb)
    (got * torch.from_numpy(ct)).sum().backward()
    _rel_close(got.detach().numpy(), want)
    for g, w in zip((ta.grad, tb.grad), want_grads):
        assert g.dtype == torch.float32
        _rel_close(g.numpy(), w)


def test_op_keeps_a_and_h_and_nothing_in_the_frozen_prefix(monkeypatch):
    """Under grad the op keeps (a, h), no shifted copy; outside grad mode
    or when no input requires grad (the SPB frozen prefix) it runs the
    same scan and records no autograd node."""
    calls = []
    real = rglru.rglru_scan
    monkeypatch.setattr(rglru, "rglru_scan",
                        lambda *a: calls.append(1) or real(*a))
    a, b, _ = _inputs(1, 20, 4, seed=9)
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (a, b))
    h = ops.rglru(ta, tb)
    saved = h.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0].data_ptr() == ta.data_ptr()
    assert saved[1].data_ptr() == h.data_ptr()
    assert ops.rglru(torch.from_numpy(a), torch.from_numpy(b)).grad_fn is None
    with torch.no_grad():
        assert ops.rglru(ta, tb).grad_fn is None
    assert calls == [1, 1, 1]


# ---------------------------------------------------------------------------
# The CUDA kernels' association order, modelled on the CPU
# ---------------------------------------------------------------------------

# csrc/rglru.cu's tile: a thread owns 16 steps, a block of 8 warps one
# 128-step chunk (channels are independent, so the 32-channel strip does
# not change a number)
LANE_STEPS, WARPS = 16, 8
CHUNK = LANE_STEPS * WARPS


def _lanes(x, fill):
    """(B, S, W) -> (B, chunks, warps, 16, W), the steps past S ``fill``
    (the identity of the recurrence)."""
    B, S, W = x.shape
    n = -(-S // CHUNK)
    pad = np.full((B, n * CHUNK - S, W), fill, np.float32)
    return np.concatenate([x, pad], 1).reshape(B, n, WARPS, LANE_STEPS, W)


def _chained_scan(a, b):
    """h as the forward kernel associates it: each lane's 16 steps scanned
    from a zero carry into the map h -> A h + H, the maps folded in warp
    order, the chunks chained in order, then each lane re-walked from its
    own carry.  f32 throughout."""
    S = a.shape[1]
    av, bv = _lanes(a, 1.0), _lanes(b, 0.0)
    A, H = np.ones_like(av[..., 0, :]), np.zeros_like(av[..., 0, :])
    for u in range(LANE_STEPS):
        H = av[..., u, :] * H + bv[..., u, :]
        A = A * av[..., u, :]
    h = np.empty_like(av)
    carry = np.zeros_like(A[:, 0, 0])
    for c in range(av.shape[1]):
        PA, PH = np.ones_like(carry), np.zeros_like(carry)
        for j in range(WARPS):
            hv = PA * carry + PH
            for u in range(LANE_STEPS):
                hv = av[:, c, j, u] * hv + bv[:, c, j, u]
                h[:, c, j, u] = hv
            PH = A[:, c, j] * PH + H[:, c, j]
            PA = PA * A[:, c, j]
        carry = PA * carry + PH
    return h.reshape(a.shape[0], -1, a.shape[2])[:, :S]


def _chained_scan_bwd(a, h, dy):
    """(da, db) as the backward kernel associates them: the same lanes on
    the map c -> a_t (dy_t + c) of c_t = a_t lam_t, folded from the last
    warp down and chained over the chunks in reverse."""
    S = a.shape[1]
    h_prev = np.concatenate([np.zeros_like(h[:, :1]), h[:, :-1]], 1)
    av, dv, hv = _lanes(a, 1.0), _lanes(dy, 0.0), _lanes(h_prev, 0.0)
    A, H = np.ones_like(av[..., 0, :]), np.zeros_like(av[..., 0, :])
    for u in reversed(range(LANE_STEPS)):
        H = av[..., u, :] * (dv[..., u, :] + H)
        A = A * av[..., u, :]
    da, db = np.empty_like(av), np.empty_like(av)
    carry = np.zeros_like(A[:, 0, 0])
    for c in reversed(range(av.shape[1])):
        PA, PH = np.ones_like(carry), np.zeros_like(carry)
        for j in reversed(range(WARPS)):
            cv = PA * carry + PH
            for u in reversed(range(LANE_STEPS)):
                lam = dv[:, c, j, u] + cv
                db[:, c, j, u], da[:, c, j, u] = lam, lam * hv[:, c, j, u]
                cv = av[:, c, j, u] * lam
            PH = A[:, c, j] * PH + H[:, c, j]
            PA = PA * A[:, c, j]
        carry = PA * carry + PH
    unlane = lambda x: x.reshape(a.shape[0], -1, a.shape[2])[:, :S]
    return unlane(da), unlane(db)


# (B, S, W, range of a, Pallas chunk, width_block): S off the 128-step
# chunk and W off the 32-channel strip; a near 0 (its products underflow)
# and near 1 (the state crosses every chunk)
@pytest.mark.parametrize("B,S,W,lo,hi,chunk,wb", [
    (2, 300, 40, 0.1, 0.999, 60, 40),
    (1, 200, 8, 0.0, 1e-3, 40, 8),
    (1, 520, 8, 0.999, 1.0, 104, 8)])
def test_kernel_association_matches_plain_and_pallas(B, S, W, lo, hi, chunk,
                                                     wb):
    rng = np.random.default_rng(S)
    a = rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    b, dy = (rng.standard_normal((B, S, W)).astype(np.float32)
             for _ in "bd")
    h = _chained_scan(a, b)
    assert h.dtype == np.float32 and np.isfinite(h).all()
    h_plain = rglru.rglru_plain(torch.from_numpy(a), torch.from_numpy(b))
    _rel_close(h, h_plain.numpy())
    h_pallas = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                                 width_block=wb, interpret=True)
    _rel_close(h, h_pallas)

    grads = _chained_scan_bwd(a, h, dy)
    plain = rglru_bwd.bwd_plain(torch.from_numpy(a), h_plain,
                                torch.from_numpy(dy))
    y_prev = jnp.pad(h_pallas, ((0, 0), (1, 0), (0, 0)))[:, :-1]
    pallas = jrglru_bwd.bwd_kernel_layout(jnp.asarray(a), y_prev,
                                          jnp.asarray(dy), chunk=chunk,
                                          width_block=wb, interpret=True)
    for g, p, j in zip(grads, plain, pallas):
        assert g.dtype == np.float32 and np.isfinite(g).all()
        _rel_close(g, p.numpy())
        _rel_close(g, j)


@pytest.mark.parametrize("name", list(rglru_tiles.VARIANTS))
def test_tile_variants_rewrite_the_kernel_source(name):
    """``analysis/rglru_tiles`` times the kernels at other tile shapes by
    rewriting csrc/rglru.cu: each variant's text must still be there."""
    tree = rglru_tiles.variant_source("tree")
    got = rglru_tiles.variant_source(name)
    old, new = rglru_tiles.VARIANTS[name]
    assert got != tree and new in got and got.replace(new, old) == tree


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; the meta device has no
    kernel, so it raises."""
    t = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        rglru.rglru_scan(t, t)
    with pytest.raises(ValueError, match="device"):
        rglru_bwd.bwd_kernel_layout(t, t, t)
    with pytest.raises(ValueError, match="shape"):
        rglru.rglru_scan(torch.zeros(1, 8, 4), torch.zeros(1, 8, 5))
