"""The CUDA kernels (flash attention, SSD scan) against their plain
versions on the card.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``
Tolerances (atol, rtol) by the output's dtype: 1e-4, 1e-4 for an f32
output (lse, delta, and every output of f32 inputs: f32 FMAs summed in
another order); 5e-3, 2e-2 for a bf16 output (both sides round an f32
result to bf16 at the end).  The SSD kernels' outputs are all f32: held at
the JAX suite's measure, max|got - want| / max(max|want|, 1) <= 1e-5.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels import ssd
from repro_torch.kernels import ssd_bwd

pytestmark = pytest.mark.cuda
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    atol, rtol = TOL[got.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", [
    (2, 128, 128, 4, 2, 32, True, 0),
    (1, 128, 128, 4, 4, 16, False, 0),
    (2, 192, 192, 8, 1, 64, True, 0),
    (1, 256, 256, 2, 2, 128, True, 64),
    (1, 100, 200, 2, 2, 32, False, 0),
])
def test_kernels_match_plain(cuda, dtype, B, Sq, Sk, H, K, D, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D), \
        mk(B, Sq, H, D)
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    before = fa.fwd_kernel_layout.launches
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
    assert fa.fwd_kernel_layout.launches == before + 1
    ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
    _close(ot, ot_p)
    _close(lse, lse_p)
    delta_p = fab.delta_plain(ot_p, dot_)
    _close(fab.compute_delta(ot_p, dot_), delta_p)
    want = (fab.dq_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw),
            *fab.dkv_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw))
    _close(fab.compute_dq(qt, kt, vt, dot_, lse_p, delta_p, **kw), want[0])
    for got, w in zip(
            fab.compute_dkv(qt, kt, vt, dot_, lse_p, delta_p, **kw), want[1:]):
        _close(got, w)
    # the chain autograd runs: backward kernels on the forward's own outputs
    for got, w in zip(fab.bwd_kernel_layout(qt, kt, vt, ot, lse, dot_, **kw),
                      want):
        _close(got, w)


def test_autograd_on_the_card_matches_the_cpu(cuda):
    gen = torch.Generator().manual_seed(1)
    q, k, v, ct = (torch.randn(s, generator=gen) for s in
                   ((2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32),
                    (2, 128, 4, 32)))
    grads = {}
    for dev in ("cpu", cuda):
        ts = [x.detach().to(dev).requires_grad_(True) for x in (q, k, v)]
        (ops.flash_attention(*ts) * ct.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,grouped", [
    (2, 64, 3, 16, 16, 32, False),      # reduced shape, divisible
    (1, 100, 2, 16, 16, 32, True),      # ragged tail, B/C head stride 0
    (1, 300, 2, 64, 128, 256, True),    # full-width shape, ragged
    (1, 50, 2, 64, 128, 256, False),    # shorter than one chunk
])
def test_ssd_kernels_match_plain(cuda, dtype, B, S, H, P, N, chunk, grouped):
    gen = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda)
    x = mk(B, S, H, P).to(dtype)
    dA = -(torch.rand((B, S, H), generator=gen, device=cuda) * 1.95 + 0.05)
    if grouped:
        b, c = (mk(B, S, 1, N).to(dtype).expand(B, S, H, N) for _ in "bc")
    else:
        b, c = mk(B, S, H, N).to(dtype), mk(B, S, H, N).to(dtype)
    dy, dstate = mk(B, S, H, P), mk(B, H, P, N)
    counts = (ssd.ssd_fwd_kernel_layout.launches,
              ssd_bwd.fwd_res_kernel_layout.launches,
              ssd_bwd.bwd_kernel_layout.launches)
    y, state = ssd.ssd_fwd_kernel_layout(x, dA, b, c, chunk=chunk)
    y2, state2, cs = ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=chunk)
    grads = ssd_bwd.bwd_kernel_layout(x, dA, b, c, cs, dy, dstate,
                                      chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd.ssd_fwd_kernel_layout.launches,
            ssd_bwd.fwd_res_kernel_layout.launches,
            ssd_bwd.bwd_kernel_layout.launches) == tuple(n + 1 for n in counts)
    yp, sp, csp = ssd_bwd.fwd_res_plain(x, dA, b, c, chunk=chunk)
    for got, want in ((y, yp), (state, sp), (y2, yp), (state2, sp),
                      (cs, csp)):
        assert got.dtype == torch.float32
        assert _rel_err(got, want) <= 1e-5
    want = ssd_bwd.bwd_plain(x, dA, b, c, csp, dy, dstate, chunk=chunk)
    for got, w in zip(grads, want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        assert _rel_err(got, w) <= 1e-5


@pytest.mark.parametrize("P,N,chunk,dtype", [
    (16, 32, 32, torch.float32),        # (P, N) not in ssd.SHAPES
    (16, 16, 512, torch.float32),       # chunk above ssd.MAX_CHUNK
    (16, 16, 32, torch.float16),        # x, b, c dtype
])
def test_ssd_kernels_refuse_other_shapes(cuda, P, N, chunk, dtype):
    """No plain fallback on the card: what the kernels do not take
    raises before anything launches."""
    B, S, H = 1, 600, 2
    x = torch.randn(B, S, H, P, device=cuda).to(dtype)
    b, c = (torch.randn(B, S, H, N, device=cuda).to(dtype) for _ in "bc")
    dA = -torch.rand(B, S, H, device=cuda)
    n = ssd.ssd_fwd_kernel_layout.launches
    with pytest.raises(ValueError, match="SSD kernels take"):
        ssd.ssd_fwd_kernel_layout(x, dA, b, c, chunk=chunk)
    with pytest.raises(ValueError, match="SSD kernels take"):
        ops.ssd(x.requires_grad_(True), dA, b, c, chunk=chunk)
    assert ssd.ssd_fwd_kernel_layout.launches == n


def test_ssd_autograd_on_the_card_matches_the_cpu(cuda):
    gen = torch.Generator().manual_seed(2)
    B, S, H, P, N = 2, 80, 4, 16, 16
    x, b, c = (torch.randn(s, generator=gen) for s in
               ((B, S, H, P), (B, S, H, N), (B, S, H, N)))
    dA = -(torch.rand((B, S, H), generator=gen) * 1.95 + 0.05)
    wy, ws = torch.randn(B, S, H, P), torch.randn(B, H, P, N)
    grads = {}
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_(True)
              for t in (x, dA, b, c)]
        y, st = ops.ssd(*ts, chunk=32)
        ((y * wy.to(dev)).sum() + (st * ws.to(dev)).sum()).backward()
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    for a, b_ in zip(grads["cpu"], grads["cuda"]):
        assert _rel_err(b_, a) <= 1e-5
