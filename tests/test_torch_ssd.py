"""The port's SSD scan on the CPU (the kernels' plain versions and the
autograd op) against the JAX Pallas kernels in interpret mode, JAX's
``ops.ssd`` and the sequential oracle.

Tolerance: the JAX suite's own (tests/test_kernel_grads.py),
max|got - want| / max(max|want|, 1) <= 1e-5 in f32 (the same f32 math
summed in another order) and 2e-2 for bf16 inputs (8-bit mantissas).
Decays are drawn as -U(0.05, 2.0), as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd import ssd_fwd_kernel_layout as j_ssd_fwd
from repro.kernels import ssd_bwd as jssd_bwd
from repro_torch.analysis import ssd_split_error as split_error
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd
from repro_torch.kernels import ssd_bwd

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

F32_TOL, BF16_TOL = 1e-5, 2e-2
# At the main path's chunk of 256 the port (csum and ddA's reverse sum
# accumulated in float64, rounded once) and the Pallas kernels (float32
# cumsum) differ by more than F32_TOL: measured up to 1.7e-5 at the
# shapes of test_chunk_256_plain_matches_pallas_and_float64, with the
# port within 7.7e-6 of a float64 oracle and Pallas within 1.0e-5.  The
# bounds leave about 3x headroom.
CHUNK256_TOL, TRUTH_TOL = 5e-5, 2e-5
# (B, S, H, P, N, chunk): divisible, ragged tail, shorter than one chunk,
# and the reduced model's (P, N, chunk)
SHAPES = pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 4, 16),
    (2, 50, 2, 4, 3, 16),
    (1, 10, 2, 8, 8, 16),
    (1, 96, 2, 16, 16, 32),
])


def _rel_close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, f"rel err {err:.3e} > {tol:g}"


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dA = -rng.uniform(0.05, 2.0, (B, S, H)).astype(np.float32)
    return f(B, S, H, P), dA, f(B, S, H, N), f(B, S, H, N), \
        f(B, S, H, P), f(B, H, P, N)


def _pallas_layout(t, Sp):
    """(B, S, H, ...) -> the Pallas kernels' (B*H, Sp, ...) with the tail
    zero-padded (dA gets a trailing unit dim)."""
    B, S, H = t.shape[:3]
    t = np.pad(t, [(0, 0), (0, Sp - S)] + [(0, 0)] * (t.ndim - 2))
    t = np.swapaxes(t, 1, 2).reshape((B * H, Sp) + t.shape[3:])
    return jnp.asarray(t if t.ndim == 3 else t[..., None])


def _from_pallas(t, B, H, S):
    t = np.asarray(t)
    t = t.reshape((B, H) + t.shape[1:])
    return np.swapaxes(t, 1, 2)[:, :S]


def _pallas_fwd(B, S, H, P, N, chunk, x, dA, b, c):
    """The Pallas forwards (interpret mode) in the port's layout, and the
    kernel-layout operands (zero-padded to whole chunks) with the chunk
    states the backward takes."""
    Sp = -(-S // chunk) * chunk
    xr, dr, br, cr = (_pallas_layout(t, Sp) for t in (x, dA, b, c))
    y, state = j_ssd_fwd(xr, dr, br, cr, chunk=chunk, interpret=True)
    y2, state2, cs = jssd_bwd.fwd_res_kernel_layout(xr, dr, br, cr,
                                                    chunk=chunk,
                                                    interpret=True)
    return {"y": _from_pallas(y, B, H, S),
            "state": np.asarray(state).reshape(B, H, P, N),
            "y_res": _from_pallas(y2, B, H, S),
            "state_res": np.asarray(state2).reshape(B, H, P, N),
            "chunk_states": np.asarray(cs).reshape(B, H, -1, P, N)}, \
        (Sp, xr, dr, br, cr, cs)


def _pallas_run(B, S, H, P, N, chunk, x, dA, b, c, dy, dst):
    want, (Sp, xr, dr, br, cr, cs) = _pallas_fwd(B, S, H, P, N, chunk, x,
                                                 dA, b, c)
    grads = jssd_bwd.bwd_kernel_layout(
        xr, dr, br, cr, cs, _pallas_layout(dy, Sp),
        jnp.asarray(dst.reshape(B * H, P, N)), chunk=chunk, interpret=True)
    want["grads"] = [_from_pallas(g, B, H, S) for g in grads]
    return want


@SHAPES
def test_forward_plain_matches_pallas(B, S, H, P, N, chunk):
    x, dA, b, c, dy, dst = _inputs(B, S, H, P, N)
    want = _pallas_run(B, S, H, P, N, chunk, x, dA, b, c, dy, dst)
    T = torch.from_numpy
    y, state = ssd.ssd_fwd_kernel_layout(T(x), T(dA), T(b), T(c), chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P)
    _rel_close(y, want["y"], F32_TOL)
    _rel_close(state, want["state"], F32_TOL)
    y2, state2, cs = ssd_bwd.fwd_res_kernel_layout(T(x), T(dA), T(b), T(c),
                                                   chunk=chunk)
    _rel_close(y2, want["y_res"], F32_TOL)
    _rel_close(state2, want["state_res"], F32_TOL)
    _rel_close(cs, want["chunk_states"], F32_TOL)


@SHAPES
def test_backward_plain_matches_pallas(B, S, H, P, N, chunk):
    x, dA, b, c, dy, dst = _inputs(B, S, H, P, N, seed=1)
    want = _pallas_run(B, S, H, P, N, chunk, x, dA, b, c, dy, dst)
    T = torch.from_numpy
    _, _, cs = ssd_bwd.fwd_res_plain(T(x), T(dA), T(b), T(c), chunk=chunk)
    got = ssd_bwd.bwd_kernel_layout(T(x), T(dA), T(b), T(c), cs, T(dy),
                                    T(dst), chunk=chunk)
    names = ("dx", "ddA", "db", "dc")
    for name, g, w in zip(names, got, want["grads"]):
        w = w[..., 0] if name == "ddA" else w
        assert tuple(g.shape) == w.shape, name
        _rel_close(g, w, F32_TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 4, 16),
    (2, 50, 2, 4, 3, 16),
    (1, 10, 2, 8, 8, 16),
    (1, 96, 2, 16, 16, 32),
    (1, 600, 2, 16, 16, 256),       # the main path's chunk, ragged
])
def test_chunk_parallel_plain_matches_bwd_plain_and_pallas(B, S, H, P, N,
                                                           chunk):
    """The chunk-parallel phases the bf16 kernels run (per-chunk U, the
    reverse state pass, per-chunk outputs), in plain PyTorch, against the
    reverse walk of bwd_plain and the Pallas _bwd_kernel, with a non-zero
    final-state cotangent."""
    x, dA, b, c, dy, dst = _inputs(B, S, H, P, N, seed=5)
    assert np.abs(dst).max() > 0
    want = _pallas_run(B, S, H, P, N, chunk, x, dA, b, c, dy, dst)
    T = torch.from_numpy
    _, _, cs = ssd_bwd.fwd_res_plain(T(x), T(dA), T(b), T(c), chunk=chunk)
    args = (T(x), T(dA), T(b), T(c), cs, T(dy), T(dst))
    got = ssd_bwd.bwd_chunk_parallel_plain(*args, chunk=chunk)
    walk = ssd_bwd.bwd_plain(*args, chunk=chunk)
    pallas_tol = CHUNK256_TOL if chunk == 256 else F32_TOL
    for name, g, r, w in zip(("dx", "ddA", "db", "dc"), got, walk,
                             want["grads"]):
        w = w[..., 0] if name == "ddA" else w
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _rel_close(g, r, F32_TOL)
        _rel_close(g, w, pallas_tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 8, 4, 16),
    (2, 50, 2, 4, 3, 16),
    (1, 10, 2, 8, 8, 16),
    (1, 96, 2, 16, 16, 32),
    (1, 600, 2, 16, 16, 256),       # the main path's chunk, ragged
])
def test_fwd_chunk_parallel_plain_matches_fwd_plain_and_pallas(B, S, H, P,
                                                               N, chunk):
    """The chunk-parallel phases the bf16 forward kernels run (per-chunk
    U, the state pass, per-chunk outputs), in plain PyTorch, against the
    in-order walk of ssd_fwd_plain and the Pallas _ssd_kernel and
    _fwd_res_kernel."""
    x, dA, b, c, _, _ = _inputs(B, S, H, P, N, seed=6)
    want, _ = _pallas_fwd(B, S, H, P, N, chunk, x, dA, b, c)
    T = torch.from_numpy
    args = (T(x), T(dA), T(b), T(c))
    got = ssd.fwd_chunk_parallel_plain(*args, chunk=chunk, with_states=True)
    walk = ssd.ssd_fwd_plain(*args, chunk=chunk, with_states=True)
    y, state = ssd.fwd_chunk_parallel_plain(*args, chunk=chunk)
    assert torch.equal(y, got[0]) and torch.equal(state, got[1])
    pallas_tol = CHUNK256_TOL if chunk == 256 else F32_TOL
    for name, g, r in zip(("y", "state", "chunk_states"), got, walk):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        _rel_close(g, r, F32_TOL)
        for key in ((name, name + "_res") if name != "chunk_states"
                    else (name,)):
            assert tuple(g.shape) == want[key].shape, key
            _rel_close(g, want[key], pallas_tol)


def test_forward_split_scheme_holds_the_tolerance():
    """The bf16 forward kernels feed their f32 operands to the tensor
    cores as bf16 parts (d x and G in three, S_in in two).  The CPU model
    of that rounding (analysis/ssd_split_error.py) at mamba2-2.7b's widths
    keeps y, the final state and the chunk states within a tenth of the
    card's SCAN_TOL (1e-5); with two parts everywhere y alone would use
    several times more of it."""
    x, dA, b, c, _, _ = split_error.inputs(0, S=1024, H=2)
    kern = split_error.forward_errors(x, dA, b, c, 256,
                                      split_error.FWD_KERNELS)
    two = split_error.forward_errors(x, dA, b, c, 256,
                                     split_error.FWD_TWO_PARTS)
    assert max(kern.values()) <= 1e-6
    assert two["y"] >= 3 * kern["y"]
    assert two["chunk_states"] >= 10 * max(kern["chunk_states"], 1e-8)


def _oracle64(x, dA, b, c, dy, dst, chunk):
    """The sequential recurrence in float64: y, the final state, the state
    entering each chunk, and by autograd the gradients of
    <y, dy> + <state, dst> for x, dA, b, c."""
    ts = [torch.from_numpy(t.astype(np.float64)).requires_grad_(True)
          for t in (x, dA, b, c)]
    X, A, Bm, Cm = ts
    Bb, S, H, P = X.shape
    h = torch.zeros((Bb, H, P, Bm.shape[-1]), dtype=torch.float64)
    ys, states = [], []
    for t in range(S):
        if t % chunk == 0:
            states.append(h.detach())
        h = h * torch.exp(A[:, t])[..., None, None] + \
            torch.einsum("bhn,bhp->bhpn", Bm[:, t], X[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], h))
    y = torch.stack(ys, dim=1)
    loss = (y * torch.from_numpy(dy.astype(np.float64))).sum() + \
        (h * torch.from_numpy(dst.astype(np.float64))).sum()
    return [y.detach(), h.detach(), torch.stack(states, dim=2)] + \
        list(torch.autograd.grad(loss, ts))


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("B,S,H,P,N,seed", [
    (1, 600, 2, 8, 8, 0), (1, 600, 2, 16, 16, 1), (2, 520, 2, 8, 4, 2)])
def test_chunk_256_plain_matches_pallas_and_float64(B, S, H, P, N, seed):
    """The main path's chunk, ragged: every output of the plain versions
    against the Pallas kernels and a float64 oracle (prints the gaps)."""
    chunk = 256
    x, dA, b, c, dy, dst = _inputs(B, S, H, P, N, seed=seed)
    want = _pallas_run(B, S, H, P, N, chunk, x, dA, b, c, dy, dst)
    pallas = [want["y"], want["state"], want["chunk_states"]] + \
        [g[..., 0] if i == 1 else g for i, g in enumerate(want["grads"])]
    T = torch.from_numpy
    y, state, cs = ssd_bwd.fwd_res_plain(T(x), T(dA), T(b), T(c),
                                         chunk=chunk)
    got = [y, state, cs] + list(ssd_bwd.bwd_plain(
        T(x), T(dA), T(b), T(c), cs, T(dy), T(dst), chunk=chunk))
    truth = _oracle64(x, dA, b, c, dy, dst, chunk)
    names = ("y", "state", "chunk_states", "dx", "ddA", "db", "dc")
    for name, g, p, o in zip(names, got, pallas, truth):
        assert np.isfinite(g.numpy()).all(), name
        gap, err, p_err = _rel_err(g, p), _rel_err(g, o), _rel_err(p, o)
        print(f"{name}: port-pallas {gap:.2e} port-float64 {err:.2e} "
              f"pallas-float64 {p_err:.2e}")
        assert gap <= CHUNK256_TOL, (name, gap)
        assert err <= TRUTH_TOL, (name, err)


def test_plain_versions_take_strided_views():
    """b and c broadcast over heads as head-stride-0 views, x as a slice:
    the same results as contiguous copies."""
    x, dA, b, c, dy, dst = _inputs(2, 40, 3, 8, 4, seed=2)
    T = torch.from_numpy
    wide = T(np.concatenate([x, x], axis=-1))[..., :8]
    b1, c1 = T(b[:, :, :1]).expand(2, 40, 3, 4), T(c[:, :, :1]).expand(
        2, 40, 3, 4)
    assert b1.stride(2) == 0 and wide.stride(-1) == 1
    got = ssd_bwd.fwd_res_kernel_layout(wide, T(dA), b1, c1, chunk=16)
    want = ssd_bwd.fwd_res_kernel_layout(T(x), T(dA), b1.contiguous(),
                                         c1.contiguous(), chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _loss(fn, x, dA, b, c, wy, ws):
    y, state = fn(x, dA, b, c)
    return (y * wy).sum() + (state * ws).sum()      # y, state are f32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 8), (33, 8), (7, 16), (64, 32)])
def test_ssd_op_grads_match_jax_and_oracle(dtype, S, chunk):
    B, H, P, N = 2, 2, 4, 3
    x, dA, b, c, _, _ = _inputs(B, S, H, P, N, seed=S + chunk)
    rng = np.random.default_rng(7)
    wy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    ws = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jin = [jnp.asarray(t).astype(jdt) for t in (x, dA, b, c)]
    want = jax.grad(lambda *a: _loss(
        lambda *t: jops.ssd(*t, chunk=chunk, interpret=True), *a,
        jnp.asarray(wy), jnp.asarray(ws)), argnums=(0, 1, 2, 3))(*jin)
    tdt = getattr(torch, dtype)
    tin = [torch.from_numpy(np.array(t.astype(jnp.float32))).to(tdt)
           .requires_grad_(True) for t in jin]
    got = torch.autograd.grad(_loss(
        lambda *t: ops.ssd(*t, chunk=chunk), *tin, torch.from_numpy(wy),
        torch.from_numpy(ws)), tin)
    oracle = torch.autograd.grad(_loss(
        ref.ssd_ref_with_state, *tin, torch.from_numpy(wy),
        torch.from_numpy(ws)), tin)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w, o, t in zip(got, want, oracle, tin):
        assert g.dtype == t.dtype
        _rel_close(g.float(), np.asarray(w.astype(jnp.float32)), tol)
        _rel_close(g.float(), o.float(), tol)


@pytest.mark.parametrize("S,chunk", [(32, 8), (33, 8), (12, 5), (7, 16)])
def test_ssd_op_values_match_jax_and_oracle(S, chunk):
    x, dA, b, c, _, _ = _inputs(2, S, 2, 4, 3, seed=S * 31 + chunk)
    y, state = ops.ssd(*(torch.from_numpy(t) for t in (x, dA, b, c)),
                       chunk=chunk)
    jy, jstate = jops.ssd(*(jnp.asarray(t) for t in (x, dA, b, c)),
                          chunk=chunk, interpret=True)
    ry, rstate = jref.ssd_ref_with_state(*(jnp.asarray(t)
                                           for t in (x, dA, b, c)))
    for got, want in ((y, jy), (state, jstate), (y, ry), (state, rstate)):
        _rel_close(got, want, F32_TOL)
    _rel_close(y, ref.ssd_ref(*(torch.from_numpy(t) for t in (x, dA, b, c))),
               F32_TOL)


def test_ssd_op_saves_nothing_without_grad():
    """The SPB frozen prefix: no input needs a gradient, so the primal
    forward runs and autograd records nothing."""
    x, dA, b, c, _, _ = _inputs(1, 20, 2, 4, 3)
    ts = [torch.from_numpy(t) for t in (x, dA, b, c)]
    y, state = ops.ssd(*ts, chunk=8)
    assert y.grad_fn is None and state.grad_fn is None
    live = [t.clone().requires_grad_(True) for t in ts]
    with torch.no_grad():
        assert ops.ssd(*live, chunk=8)[0].grad_fn is None
    y2, _ = ops.ssd(*live, chunk=8)
    assert type(y2.grad_fn).__name__ == "_SSDBackward"
    torch.testing.assert_close(y2.detach(), y, rtol=0, atol=0)


def test_wrappers_check_shapes():
    x, dA, b, c, dy, dst = (torch.from_numpy(t) for t in _inputs(1, 16, 2, 4, 3))
    with pytest.raises(ValueError, match="incompatible"):
        ssd.ssd_fwd_kernel_layout(x, dA[:, :8], b, c, chunk=8)
    _, _, cs = ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=8)
    with pytest.raises(ValueError, match="chunk_states"):
        ssd_bwd.bwd_kernel_layout(x, dA, b, c, cs, dy, dst, chunk=4)
    with pytest.raises(ValueError, match="no SSD kernel"):
        ssd.kernel_dtype_code(x, dA, b, c, 4, 3, 8)
