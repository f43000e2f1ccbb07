"""The port's flash attention on the CPU (the kernels' plain versions and
the autograd wrapper) against the JAX Pallas kernels in interpret mode and
against the attention oracle's autodiff.

Tolerance: rtol = atol = 2e-4, the repo's own for these kernels
(tests/test_flash_attention_bwd.py): f32 math, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention_bwd as jfab
from repro.kernels.flash_attention import fwd_kernel_layout as j_fwd
from repro.kernels.ops import flash_attention as j_flash_attention
from repro_torch.analysis import delta_tiles
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels import ref

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", [
    (2, 128, 128, 4, 2, 32, True, 0),      # GQA causal
    (1, 128, 128, 4, 4, 32, False, 0),     # MHA bidirectional
    (2, 128, 128, 8, 1, 64, True, 0),      # MQA
    (1, 256, 256, 2, 2, 64, True, 64),     # sliding window
    (1, 128, 256, 2, 2, 32, False, 0),     # cross-shaped (Sq != Sk)
    (1, 128, 128, 4, 1, 256, True, 48),    # recurrentgemma: D 256, MQA, window
])


def _inputs(B, Sq, Sk, H, K, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, H, D), f(B, Sk, K, D), f(B, Sk, K, D), f(B, Sq, H, D)


def _kl(x):                      # (B,S,H,D) -> kernel layout (B,H,S,D)
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


@SHAPES
def test_forward_plain_matches_pallas(B, Sq, Sk, H, K, D, causal, window):
    q, k, v, _ = _inputs(B, Sq, Sk, H, K, D)
    want_o, want_lse = j_fwd(
        _kl(q), _kl(k), _kl(v), causal=causal, window=window, q_block=64,
        kv_block=64, with_lse=True, interpret=True)
    qt, kt, vt = (torch.from_numpy(_kl(x)) for x in (q, k, v))
    got_o, got_lse = fa.fwd_kernel_layout(qt, kt, vt, causal=causal,
                                          window=window, with_lse=True)
    got_plain = fa.fwd_kernel_layout(qt, kt, vt, causal=causal,
                                     window=window)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    np.testing.assert_array_equal(got_plain.numpy(), got_o.numpy())


@SHAPES
def test_vjp_matches_pallas_and_ref(B, Sq, Sk, H, K, D, causal, window):
    q, k, v, ct = _inputs(B, Sq, Sk, H, K, D)

    def j_loss(q, k, v):
        return jnp.sum(j_flash_attention(
            q, k, v, causal=causal, window=window, q_block=64, kv_block=64,
            interpret=True) * ct)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(q, k, v)

    def t_grads(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        (fn(*ts) * torch.from_numpy(ct)).sum().backward()
        return [t.grad.numpy() for t in ts]

    got = t_grads(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=causal, window=window, q_block=64, kv_block=64))
    oracle = t_grads(lambda q, k, v: ref.attention_ref(
        q, k, v, causal=causal, window=window))
    for g, w, o, name in zip(got, want, oracle, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                   err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(g, o, **TOL, err_msg=f"d{name} vs ref")


@pytest.mark.parametrize("B,H,Sq,D,dtype,q_block,transposed", [
    (2, 4, 128, 32, "float32", 64, False),
    (1, 2, 96, 16, "float32", 32, True),      # Sq not a multiple of 64
    (1, 3, 64, 64, "float32", 64, True),
    (1, 2, 96, 128, "float32", 32, False),
    (1, 2, 64, 256, "float32", 64, True),
    (1, 2, 96, 128, "bfloat16", 32, True),    # yi-6b's dtype and head_dim
    (2, 1, 64, 256, "bfloat16", 64, True),    # recurrentgemma-2b's
])
def test_delta_matches_pallas(B, H, Sq, D, dtype, q_block, transposed):
    """compute_delta on the CPU against the Pallas delta kernel; with
    ``transposed`` the port gets (B, H, Sq, D) views of (B, Sq, H, D)
    tensors, as the main path hands them.  bf16 inputs are the same
    rounded values on both sides, summed in f32."""
    rng = np.random.default_rng(3)
    o, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    want = jfab._compute_delta(
        *(jnp.asarray(_kl(x), dtype=getattr(jnp, dtype)) for x in (o, do)),
        q_block, True)
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (o, do)]
    t = ([x.transpose(1, 2) for x in t] if transposed else
         [x.transpose(1, 2).contiguous() for x in t])
    got = fab.compute_delta(*t)
    assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_residual_forward_equals_plain_forward():
    """The lse-saving forward under autograd equals the forward without
    lse (same plain math, extra output)."""
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 32, seed=1)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    with_grad = ops.flash_attention(*ts, causal=True)
    plain = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=True)
    np.testing.assert_allclose(with_grad.detach().numpy(), plain.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_no_grad_call_saves_no_lse(monkeypatch):
    """The SPB frozen prefix: no input needs grad, or grad mode is off ->
    the forward runs without lse and records no autograd node."""
    calls = []
    real = fa.fwd_kernel_layout

    def spy(*a, **kw):
        calls.append(kw.get("with_lse", False))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "fwd_kernel_layout", spy)
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 16, seed=2)
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    assert ops.flash_attention(*plain).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(*leaves).grad_fn is None
    assert calls == [False, False]
    assert ops.flash_attention(*leaves).grad_fn is not None
    assert calls == [False, False, True]


def test_ragged_call_matches_ref():
    """Lengths that no block size tiles: the op takes them (the block
    sizes only mirror the JAX signature) and its values and gradients
    match the oracle's."""
    q, k, v, ct = _inputs(1, 200, 200, 2, 2, 16)

    def run(fn):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fn(*ts)
        (out * torch.from_numpy(ct)).sum().backward()
        return [out.detach().numpy()] + [t.grad.numpy() for t in ts]

    got = run(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True, q_block=128, kv_block=128))
    want = run(lambda q, k, v: ref.attention_ref(q, k, v, causal=True))
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device must
    launch a kernel or raise (here: the meta device, which has none)."""
    qt = torch.empty((1, 2, 64, 16), device="meta")
    kt = torch.empty((1, 1, 64, 16), device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        fa.fwd_kernel_layout(qt, kt, kt)
    with pytest.raises(ValueError, match="device"):
        fab.compute_delta(qt, qt)
    with pytest.raises(ValueError, match="device"):
        fab.compute_dq(qt, kt, kt, qt, lse, lse)
    with pytest.raises(ValueError, match="device"):
        fab.compute_dkv(qt, kt, kt, qt, lse, lse)


@pytest.mark.parametrize("B,K,G,Sk,D,want", [
    (2, 4, 8, 2048, 128, 2),    # yi-6b: 16 kv-tile pairs x 8 = 128 blocks, 264 slots
    (2, 1, 10, 2048, 256, 10),  # recurrentgemma-2b: 32 blocks on 132 SMs
    (1, 1, 1, 2048, 256, 1),    # one q head: nothing to split
    (16, 8, 4, 4096, 128, 1),   # the grid fills the card without a split
])
def test_dkv_head_splits(B, K, G, Sk, D, want):
    """The bf16 dkv kernel's head split: a divisor of G, above 1 only
    where it cuts the busiest SM's work by more than a quarter."""
    splits = fab.dkv_head_splits(B, K, G, Sk, D, sms=132)
    assert splits == want and G % splits == 0


def test_check_aligned_refuses_what_the_copies_cannot_take():
    """The bf16 tensor-core kernels copy 16-byte chunks."""
    buf = torch.zeros(1 + 2 * 64 * 4 * 64, dtype=torch.bfloat16)
    fa.check_aligned(buf[:-1].view(2, 64, 4, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_aligned(buf[1:].view(2, 64, 4, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 8"):
        fa.check_aligned(buf[:2 * 64 * 4 * 60].view(2, 64, 4, 60)
                         .transpose(1, 2))


def test_check_aligned_takes_f32_in_16_byte_chunks():
    """The delta kernel copies 16-byte chunks in f32 too: 4 elements."""
    buf = torch.zeros(4 + 2 * 64 * 4 * 64)
    fa.check_aligned(buf[:-4].view(2, 64, 4, 64).transpose(1, 2))
    fa.check_aligned(buf[4:4 + 2 * 64 * 4 * 20].view(2, 64, 4, 20)
                     .transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_aligned(buf[1:-3].view(2, 64, 4, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 4"):
        fa.check_aligned(buf[:2 * 64 * 4 * 18].view(2, 64, 4, 18)
                         .transpose(1, 2))


@pytest.mark.parametrize("nt,rpt", delta_tiles.GRID)
def test_delta_tile_variants_rewrite_the_kernel_source(nt, rpt):
    """``analysis/delta_tiles`` times the delta kernel at other block
    shapes by rewriting csrc/flash_delta.cu's two constants."""
    tree = (_build.CSRC / "flash_delta.cu").read_text()
    got = delta_tiles.variant_source(nt, rpt)
    assert f"constexpr int DELTA_NT = {nt};" in got
    assert f"constexpr int DELTA_RPT = {rpt};" in got
    assert (got == tree) == ((nt, rpt) == delta_tiles.tree_pair())
    assert delta_tiles.tree_pair() in delta_tiles.GRID
