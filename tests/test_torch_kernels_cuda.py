"""The CUDA kernels (flash attention, SSD scan, RG-LRU scan) against their
plain versions on the card.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``
Tolerances (atol, rtol) by the output's dtype: 1e-4, 1e-4 for an f32
output (lse, delta, and every output of f32 inputs: f32 FMAs summed in
another order); 5e-3, 2e-2 for a bf16 output (both sides round an f32
result to bf16 at the end).  The SSD kernels' outputs are all f32: held at
the JAX suite's measure, max|got - want| / max(max|want|, 1) <= 1e-5, and
so are the RG-LRU kernels' (f32 in, f32 out; one FMA where the plain
version rounds a product and a sum).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.kernels import rglru
from repro_torch.kernels import rglru_bwd
from repro_torch.kernels import ssd
from repro_torch.kernels import ssd_bwd

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

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


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", [
    (1, 100, 200, 4, 2, 128, False, 0),    # ragged, Sq != Sk
    (2, 200, 200, 4, 1, 128, True, 0),     # ragged S
    (1, 100, 200, 2, 1, 256, False, 0),
    (2, 200, 200, 4, 1, 256, True, 0),
    (1, 256, 256, 8, 1, 128, True, 0),     # GQA, G 8
    (1, 320, 320, 10, 1, 256, True, 100),  # MQA, G 10; the window crosses tiles
    (2, 192, 192, 4, 2, 128, False, 0),    # non-causal
])
def test_tensor_core_kernels_at_the_edges(cuda, B, Sq, Sk, H, K, D, causal,
                                          window):
    """The bf16 forward and dkv (wgmma) where tiles are partly masked or
    cut by the sequence's end; the backward also on the forward's own
    outputs."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D), \
        mk(B, Sq, H, D)
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
    ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
    _close(ot, ot_p)
    _close(lse, lse_p)
    delta_p = fab.delta_plain(ot_p, dot_)
    want = fab.dkv_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw)
    for got, w in zip(fab.compute_dkv(qt, kt, vt, dot_, lse_p, delta_p, **kw),
                      want):
        _close(got, w)
    for got, w in zip(fab.bwd_kernel_layout(qt, kt, vt, ot, lse, dot_,
                                            **kw)[1:], want):
        _close(got, w)


@pytest.mark.parametrize("H,K,D", [(8, 1, 128), (10, 1, 256), (4, 2, 64)])
def test_dkv_is_deterministic(cuda, H, K, D):
    """One owner per dK/dV element and a fixed-order reduction of the head
    split's partial sums: two calls give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, S = 1, 512
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    qt, kt, vt, dot_ = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True)
    delta = fab.compute_delta(ot, dot_)
    first = fab.compute_dkv(qt, kt, vt, dot_, lse, delta)
    again = fab.compute_dkv(qt, kt, vt, dot_, lse, delta)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", [
    (1, 100, 200, 4, 2, 128, False, 0),    # ragged, Sq != Sk
    (2, 200, 200, 4, 1, 128, True, 0),     # ragged S
    (1, 256, 256, 8, 1, 128, True, 0),     # GQA, G 8
    (1, 320, 320, 10, 1, 256, True, 100),  # MQA, G 10; the window crosses tiles
    (2, 192, 192, 4, 2, 64, False, 0),     # non-causal
    (2, 200, 200, 4, 1, 256, True, 0),     # D 256, ragged
    (1, 100, 200, 2, 1, 256, False, 0),    # D 256, Sq != Sk
    (1, 128, 128, 4, 4, 16, True, 0),      # D 16, zero-padded to 64
])
def test_dq_tensor_core_kernel_at_the_edges(cuda, B, Sq, Sk, H, K, D, causal,
                                            window):
    """The bf16 dq (wgmma) where tiles are partly masked or cut by the
    sequence's end, against dq_plain; also on the forward's own outputs."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D), \
        mk(B, Sq, H, D)
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
    delta_p = fab.delta_plain(ot_p, dot_)
    want = fab.dq_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw)
    n = fab.compute_dq.launches
    _close(fab.compute_dq(qt, kt, vt, dot_, lse_p, delta_p, **kw), want)
    assert fab.compute_dq.launches == n + 1
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
    _close(fab.bwd_kernel_layout(qt, kt, vt, ot, lse, dot_, **kw)[0], want)


@pytest.mark.parametrize("H,K,D,window", [(8, 1, 128, 0), (10, 1, 256, 0),
                                          (4, 2, 64, 96)])
def test_dq_is_deterministic(cuda, H, K, D, window):
    """One owner per dQ row, no atomics: two calls give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, S = 1, 512
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2)
    qt, kt, vt, dot_ = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, window=window)
    delta = fab.compute_delta(ot, dot_)
    first = fab.compute_dq(qt, kt, vt, dot_, lse, delta, window=window)
    again = fab.compute_dq(qt, kt, vt, dot_, lse, delta, window=window)
    assert torch.equal(first, again)


def test_dq_refuses_misaligned_operands(cuda):
    """The bf16 dq copies 16-byte chunks: an operand whose data does not
    start 16-byte aligned raises before anything launches."""
    buf = torch.randn(1 + 64 * 2 * 64, device=cuda).to(torch.bfloat16)
    bad = buf[1:].view(1, 64, 2, 64).transpose(1, 2)
    lse = torch.zeros(1, 2, 64, device=cuda)
    n = fab.compute_dq.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        fab.compute_dq(bad, bad, bad, bad, lse, lse)
    assert fab.compute_dq.launches == n


def test_tensor_core_kernels_refuse_misaligned_operands(cuda):
    """The bf16 kernels copy 16-byte chunks: an operand whose data does
    not start 16-byte aligned raises before anything launches."""
    buf = torch.randn(1 + 64 * 2 * 64, device=cuda).to(torch.bfloat16)
    bad = buf[1:].view(1, 64, 2, 64).transpose(1, 2)
    counts = (fa.fwd_kernel_layout.launches, fab.compute_dkv.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.fwd_kernel_layout(bad, bad, bad)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fab.compute_dkv(bad, bad, bad, bad, lse, lse)
    assert (fa.fwd_kernel_layout.launches,
            fab.compute_dkv.launches) == counts


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


def _ssd_bwd_inputs(cuda, dtype, B, S, H, P, N, chunk, grouped, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda)
    x = mk(B, S, H, P).to(dtype)
    dA = -(torch.rand((B, S, H), generator=gen, device=cuda) * 1.95 + 0.05)
    heads = 1 if grouped else H
    b, c = (mk(B, S, heads, N).to(dtype).expand(B, S, H, N) for _ in "bc")
    dy, dstate = mk(B, S, H, P), mk(B, H, P, N)
    _, _, cs = ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=chunk)
    return x, dA, b, c, cs, dy, dstate


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,grouped", [
    (2, 600, 3, 64, 128, 256, True),    # the main shape's widths, ragged
    (1, 130, 2, 64, 128, 64, False),    # several chunks, short last one
    (2, 100, 3, 16, 16, 32, True),      # reduced widths, ragged
])
def test_ssd_bwd_matches_plain_and_is_deterministic(cuda, dtype, B, S, H, P,
                                                    N, chunk, grouped):
    """The backward (bf16: the chunk-parallel tensor-core kernels; f32: the
    reverse walk) against bwd_plain and against the plain chunk-parallel
    decomposition, with a non-zero dstate; two calls give equal bits."""
    args = _ssd_bwd_inputs(cuda, dtype, B, S, H, P, N, chunk, grouped, 11)
    n = ssd_bwd.bwd_kernel_layout.launches
    got = ssd_bwd.bwd_kernel_layout(*args, chunk=chunk)
    again = ssd_bwd.bwd_kernel_layout(*args, chunk=chunk)
    assert ssd_bwd.bwd_kernel_layout.launches == n + 2
    want = ssd_bwd.bwd_plain(*args, chunk=chunk)
    phases = ssd_bwd.bwd_chunk_parallel_plain(*args, chunk=chunk)
    for g, a, w, p in zip(got, again, want, phases):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)
        assert _rel_err(g, w) <= 1e-5
        assert _rel_err(g, p) <= 1e-5


def test_ssd_bwd_refuses_misaligned_operands(cuda):
    """The bf16 backward copies 16-byte chunks: x starting off a 16-byte
    boundary raises before anything launches."""
    B, S, H, P, N = 1, 64, 2, 16, 16
    args = list(_ssd_bwd_inputs(cuda, torch.bfloat16, B, S, H, P, N, 32,
                                False, 12))
    buf = torch.zeros(1 + B * S * H * P, device=cuda, dtype=torch.bfloat16)
    args[0] = buf[1:].view(B, S, H, P)
    n = ssd_bwd.bwd_kernel_layout.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd_bwd.bwd_kernel_layout(*args, chunk=32)
    assert ssd_bwd.bwd_kernel_layout.launches == n


def _ssd_fwd_inputs(cuda, B, S, H, P, N, grouped, seed):
    """bf16 x, b, c (b and c head-stride-0 views when ``grouped``), f32
    dA, dy and dstate on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda)
    x = mk(B, S, H, P).bfloat16()
    dA = -(torch.rand((B, S, H), generator=gen, device=cuda) * 1.95 + 0.05)
    heads = 1 if grouped else H
    b, c = (mk(B, S, heads, N).bfloat16().expand(B, S, H, N) for _ in "bc")
    return x, dA, b, c, mk(B, S, H, P), mk(B, H, P, N)


@pytest.mark.parametrize("B,S,H,P,N,chunk,grouped", [
    (2, 2048, 80, 64, 128, 256, True),  # mamba2-2.7b's main shape
    (2, 600, 3, 64, 128, 256, True),    # the main widths, ragged
    (1, 130, 2, 64, 128, 64, False),    # several chunks, short last one
    (2, 100, 3, 16, 16, 32, True),      # reduced widths, ragged
    (1, 50, 2, 16, 16, 256, False),     # shorter than one chunk
])
def test_bf16_ssd_forwards_match_plain_and_are_deterministic(
        cuda, B, S, H, P, N, chunk, grouped):
    """The bf16 forwards (the chunk-parallel tensor-core kernels) against
    ssd_fwd_plain and the plain chunk-parallel phases; two calls give equal
    bits, one launch count each; ssd_fwd_res's chunk states feed ssd_bwd
    as the plain ones do."""
    x, dA, b, c, dy, dstate = _ssd_fwd_inputs(cuda, B, S, H, P, N, grouped,
                                              13)
    n = (ssd.ssd_fwd_kernel_layout.launches,
         ssd_bwd.fwd_res_kernel_layout.launches)
    y, state = ssd.ssd_fwd_kernel_layout(x, dA, b, c, chunk=chunk)
    got = ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=chunk)
    again = ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=chunk)
    y2, _ = ssd.ssd_fwd_kernel_layout(x, dA, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd.ssd_fwd_kernel_layout.launches,
            ssd_bwd.fwd_res_kernel_layout.launches) == (n[0] + 2, n[1] + 2)
    want = ssd.ssd_fwd_plain(x, dA, b, c, chunk=chunk, with_states=True)
    phases = ssd.fwd_chunk_parallel_plain(x, dA, b, c, chunk=chunk,
                                          with_states=True)
    assert torch.equal(y, y2) and torch.equal(y, got[0])
    assert torch.equal(state, got[1])
    for g, a, w, p in zip(got, again, want, phases):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, a)
        assert _rel_err(g, w) <= 1e-5
        assert _rel_err(g, p) <= 1e-5
    grads = ssd_bwd.bwd_kernel_layout(x, dA, b, c, got[2], dy, dstate,
                                      chunk=chunk)
    for g, w in zip(grads, ssd_bwd.bwd_plain(x, dA, b, c, want[2], dy,
                                             dstate, chunk=chunk)):
        assert _rel_err(g, w) <= 1e-5


def test_ssd_forwards_refuse_misaligned_operands(cuda):
    """The bf16 forwards copy 16-byte chunks: x starting off a 16-byte
    boundary, or c with a sequence stride that is not a multiple of 16
    bytes, raises before anything launches."""
    B, S, H, P, N = 1, 64, 2, 16, 16
    x, dA, b, c, _, _ = _ssd_fwd_inputs(cuda, B, S, H, P, N, False, 14)
    buf = torch.zeros(1 + x.numel(), device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:].view(B, S, H, P)
    shifted.copy_(x)
    wide = torch.zeros(B, S, H, N + 4, device=cuda, dtype=torch.bfloat16)
    strided = wide[..., :N]
    strided.copy_(c)
    n = (ssd.ssd_fwd_kernel_layout.launches,
         ssd_bwd.fwd_res_kernel_layout.launches)
    for args in ((shifted, dA, b, c), (x, dA, b, strided)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ssd.ssd_fwd_kernel_layout(*args, chunk=32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ssd_bwd.fwd_res_kernel_layout(*args, chunk=32)
    assert (ssd.ssd_fwd_kernel_layout.launches,
            ssd_bwd.fwd_res_kernel_layout.launches) == n


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


def _flash_chain_bf16(cuda, B, S, H, K, D, window):
    """The bf16 forward, dq and dkv kernels and the backward chain on the
    forward kernel's own outputs against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v, do = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=True, window=window)
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
    ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
    _close(ot, ot_p)
    _close(lse, lse_p)
    delta_p = fab.delta_plain(ot_p, dot_)
    want = (fab.dq_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw),
            *fab.dkv_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw))
    got = (fab.compute_dq(qt, kt, vt, dot_, lse_p, delta_p, **kw),
           *fab.compute_dkv(qt, kt, vt, dot_, lse_p, delta_p, **kw))
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(fab.bwd_kernel_layout(qt, kt, vt, ot, lse, dot_, **kw),
                    want):
        _close(g, w)


@pytest.mark.parametrize("B,S,H,K,window", [
    (1, 256, 10, 1, 64),    # recurrentgemma's MQA group, the window bites
    (2, 200, 4, 1, 2048),   # ragged, the window wider than S
    (1, 384, 8, 4, 100),    # gemma3's G 2, a window across 64-row tiles
    (2, 256, 8, 4, 0),      # gemma3's global layer
])
def test_flash_kernels_at_head_dim_256(cuda, B, S, H, K, window):
    """recurrentgemma-2b's local attention (D 256, one kv head) and
    gemma3-4b's local and global attention (D 256, 4 kv heads), bf16."""
    _flash_chain_bf16(cuda, B, S, H, K, 256, window)


@pytest.mark.parametrize("B,S", [(1, 256), (2, 2048)])
def test_flash_kernels_at_a_16_head_gqa_group(cuda, B, S):
    """qwen3-moe-235b-a22b's attention: 64 q heads over 4 kv heads (G 16),
    D 128, causal, bf16; at S 2048 the dkv planner splits each group as at
    full width, at S 256 into single heads."""
    _flash_chain_bf16(cuda, B, S, 64, 4, 128, 0)


def test_flash_kernels_refuse_f32_at_head_dim_256(cuda):
    q = torch.randn(1, 2, 64, 256, device=cuda)
    n = fa.fwd_kernel_layout.launches
    with pytest.raises(ValueError, match="bfloat16 at head_dim 256"):
        fa.fwd_kernel_layout(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="attention kernels take"):
        fa.fwd_kernel_layout(*(torch.randn(1, 2, 64, 96, device=cuda)
                               .to(torch.bfloat16) for _ in "qkv"))
    assert fa.fwd_kernel_layout.launches == n


# every (dtype, head_dim) pair the delta kernel is instantiated for
DELTA_PAIRS = ([(torch.float32, D) for D in (16, 32, 64, 128)]
               + [(torch.bfloat16, D) for D in (16, 32, 64, 128, 256)])


@pytest.mark.parametrize("dtype,D", DELTA_PAIRS)
@pytest.mark.parametrize("B,H,Sq", [(1, 1, 1), (3, 5, 100), (1, 3, 2048)])
def test_delta_kernel_matches_plain_at_every_head_dim(cuda, dtype, D, B, H,
                                                      Sq):
    """The delta kernel at ragged row counts (B * H odd) on contiguous
    (B, H, Sq, D) tensors and on transposed (B, S, H, D) views, against
    delta_plain at the f32 tolerance; two calls give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    for ot, dot_ in ((mk(B, H, Sq, D), mk(B, H, Sq, D)),
                     (mk(B, Sq, H, D).transpose(1, 2),
                      mk(B, Sq, H, D).transpose(1, 2))):
        n = fab.compute_delta.launches
        got = fab.compute_delta(ot, dot_)
        assert fab.compute_delta.launches == n + 1
        assert got.dtype == torch.float32 and got.shape == (B, H, Sq)
        _close(got, fab.delta_plain(ot, dot_))
        assert torch.equal(got, fab.compute_delta(ot, dot_))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_kernel_refuses_misaligned_operands(cuda, dtype):
    """The delta kernel loads 16-byte chunks: data one element off 16
    bytes, or a sequence stride that is no multiple of 16 bytes, raises
    before anything launches."""
    n = 2 * 64 * 64
    buf = torch.randn(64 * 130 + 1, device=cuda).to(dtype)
    good = buf[:n].view(1, 64, 2, 64).transpose(1, 2)
    off = buf[1:n + 1].view(1, 64, 2, 64).transpose(1, 2)
    padded = torch.as_strided(buf, (1, 2, 64, 64), (64 * 130, 64, 130, 1))
    count = fab.compute_delta.launches
    for bad, match in ((off, "16-byte aligned"), (padded, "multiples of")):
        with pytest.raises(ValueError, match=match):
            fab.compute_delta(bad, good)
        with pytest.raises(ValueError, match=match):
            fab.compute_delta(good, bad)
    assert fab.compute_delta.launches == count
    with pytest.raises(ValueError, match="attention kernels take"):
        fab.compute_delta(*(torch.zeros(1, 2, 64, 96, device=cuda,
                                        dtype=dtype) for _ in "od"))
    with pytest.raises(ValueError, match="bfloat16 at head_dim 256"):
        fab.compute_delta(*(torch.zeros(1, 2, 64, 256, device=cuda)
                            for _ in "od"))
    assert fab.compute_delta.launches == count


# the kernels' tile is 128 steps by 32 channels: (2, 129, 33) and
# (3, 1000, 100) miss it in both S and W
@pytest.mark.parametrize("B,S,W", [
    (2, 64, 32), (2, 600, 64), (3, 17, 130), (1, 1, 5), (2, 2048, 2560),
    (2, 129, 33), (3, 1000, 100)])
def test_rglru_kernels_match_plain(cuda, B, S, W):
    gen = torch.Generator(device=cuda).manual_seed(4)
    a = torch.rand((B, S, W), generator=gen, device=cuda) * 0.899 + 0.1
    b, dy = (torch.randn((B, S, W), generator=gen, device=cuda)
             for _ in "bd")
    counts = (rglru.rglru_scan.launches, rglru_bwd.bwd_kernel_layout.launches)
    h = rglru.rglru_scan(a, b)
    da, db = rglru_bwd.bwd_kernel_layout(a, h, dy)
    torch.cuda.synchronize()
    assert (rglru.rglru_scan.launches,
            rglru_bwd.bwd_kernel_layout.launches) == tuple(
                n + 1 for n in counts)
    h_p = rglru.rglru_plain(a, b)
    assert h.dtype == torch.float32 and _rel_err(h, h_p) <= 1e-5
    for got, want in zip((da, db), rglru_bwd.bwd_plain(a, h_p, dy)):
        assert got.dtype == torch.float32 and _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rglru_kernels_refuse_non_f32(cuda, dtype):
    """No plain fallback on the card: a non-f32 input raises before
    anything launches."""
    a = torch.rand(2, 16, 8, device=cuda).to(dtype)
    counts = (rglru.rglru_scan.launches, rglru_bwd.bwd_kernel_layout.launches)
    with pytest.raises(ValueError, match="RG-LRU kernels take float32"):
        rglru.rglru_scan(a, a)
    with pytest.raises(ValueError, match="RG-LRU kernels take float32"):
        ops.rglru(a.requires_grad_(True), a)
    with pytest.raises(ValueError, match="RG-LRU kernels take float32"):
        rglru_bwd.bwd_kernel_layout(a.float(), a.float(), a)
    assert (rglru.rglru_scan.launches,
            rglru_bwd.bwd_kernel_layout.launches) == counts


@pytest.mark.parametrize("B,S,W", [(2, 2048, 2560), (64, 8192, 512)])
def test_rglru_kernels_are_deterministic_and_finish_any_grid(cuda, B, S, W):
    """Each tile combines with its one predecessor in a fixed order, so two
    calls give the same bits; (64, 8192, 512) hands out 65536 tiles, far
    more than the card holds at once, and every one must still get its
    carry (the tiles are taken from a ticket in walk order)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    a = torch.rand((B, S, W), generator=gen, device=cuda) * 0.899 + 0.1
    b, dy = (torch.randn((B, S, W), generator=gen, device=cuda)
             for _ in "bd")
    h, again = rglru.rglru_scan(a, b), rglru.rglru_scan(a, b)
    grads = rglru_bwd.bwd_kernel_layout(a, h, dy)
    grads_again = rglru_bwd.bwd_kernel_layout(a, h, dy)
    torch.cuda.synchronize()
    assert torch.equal(h, again)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads_again))
    h_p = rglru.rglru_plain(a, b)
    assert _rel_err(h, h_p) <= 1e-5
    for got, want in zip(grads, rglru_bwd.bwd_plain(a, h_p, dy)):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("lo,hi", [(0.0, 1e-3), (0.999, 1.0)])
def test_rglru_kernels_with_a_near_0_and_near_1(cuda, lo, hi):
    """a near 0 underflows the tiles' products of a (no division, so no
    inf or NaN); a near 1 carries the state across every tile."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    shape = (2, 700, 96)
    a = torch.rand(shape, generator=gen, device=cuda) * (hi - lo) + lo
    b, dy = (torch.randn(shape, generator=gen, device=cuda) for _ in "bd")
    h = rglru.rglru_scan(a, b)
    h_p = rglru.rglru_plain(a, b)
    assert _rel_err(h, h_p) <= 1e-5
    for got, want in zip(rglru_bwd.bwd_kernel_layout(a, h, dy),
                         rglru_bwd.bwd_plain(a, h_p, dy)):
        assert _rel_err(got, want) <= 1e-5


def test_rglru_autograd_on_the_card_matches_the_cpu(cuda):
    gen = torch.Generator().manual_seed(5)
    a = torch.rand((2, 100, 48), generator=gen) * 0.899 + 0.1
    b, w = (torch.randn((2, 100, 48), generator=gen) for _ in "bw")
    grads = {}
    for dev in ("cpu", cuda):
        ts = [t.detach().to(dev).requires_grad_(True) for t in (a, b)]
        (ops.rglru(*ts) * w.to(dev)).sum().backward()
        grads[str(dev)] = [t.grad.cpu() for t in ts]
    for x, y in zip(grads["cpu"], grads["cuda"]):
        assert _rel_err(y, x) <= 1e-5


def test_attention_gate_never_falls_back_on_the_card(cuda):
    """A sequence the JAX shape gate would send to the blockwise path
    (S 200) takes the kernels on the card and agrees with the CPU."""
    from repro_torch.models import layers
    gen = torch.Generator().manual_seed(6)
    q, k = torch.randn(1, 200, 4, 16, generator=gen), \
        torch.randn(1, 200, 2, 16, generator=gen)
    n = fa.fwd_kernel_layout.launches
    out = layers._pallas_attention(q.to(cuda), k.to(cuda), k.to(cuda),
                                   causal=True, window=0)
    assert out is not None and fa.fwd_kernel_layout.launches == n + 1
    want = layers.blockwise_attention(q, k, k, causal=True)
    torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b", "recurrentgemma-2b"])
def test_temporal_mb_step_on_the_card(cuda, arch):
    """One temporal-mb step (f32, kernels on, batch 4 x 64: one microbatch
    at each depth of the k=4 cycle) launches each kernel as often as its
    cycle's depths ask (``chip_smoke.expected_launches``), and its loss is
    the CPU step's to 1e-3 relative, from the same weights."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.core import spb as spb_lib
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=1), SPBConfig(mode="temporal-mb", k=4)
    sched = spb_lib.make_schedule(cfg, spb)
    cycle = [sched.depths[i] for i in sched.order]
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = Pipeline(cfg, 4, 64, seed=0).get_batch(0)
    losses = {}
    for dev in ("cpu", "cuda"):
        eng = SPBEngine(cfg, tcfg, spb, device=dev)
        eng.attach_state(steps_lib.state_from_params(
            tree_map(torch.clone, params), tcfg))
        before = smoke.launches_now()
        losses[dev] = float(eng.train_step(batch, 0)["loss"])
        grew = smoke.launches_since(before)
        if dev == "cuda":
            assert grew == smoke.expected_launches(cfg, cycle)
        else:
            assert not any(grew.values())
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-3 * abs(losses["cpu"])


@pytest.mark.parametrize("dtype,D", [(torch.float32, 32),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 256)])
def test_flash_kernels_take_an_explicit_scale(cuda, dtype, D):
    """The forward, dq and dkv kernels with a score scale other than
    1 / sqrt(D) against the plain versions at the same scale."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    mk = lambda *s: torch.randn(s, generator=gen, device=cuda).to(dtype)
    B, S, H, K = 2, 192, 4, 2
    q, k, v, do = mk(B, S, H, D), mk(B, S, K, D), mk(B, S, K, D), \
        mk(B, S, H, D)
    qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=True, window=0, scale=0.3 / D ** 0.5)
    ot, lse = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
    ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
    _close(ot, ot_p)
    _close(lse, lse_p)
    delta_p = fab.delta_plain(ot_p, dot_)
    want = (fab.dq_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw),
            *fab.dkv_plain(qt, kt, vt, dot_, lse_p, delta_p, **kw))
    for g, w in zip(fab.bwd_kernel_layout(qt, kt, vt, ot, lse, dot_, **kw),
                    want):
        _close(g, w)
    # the default is 1 / sqrt(D), and the scale changes the result
    unscaled = fa.fwd_kernel_layout(qt, kt, vt)
    _close(unscaled, fa.fwd_plain(qt, kt, vt))
    assert float((unscaled.float() - ot.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("B,S,H,dqk,dv,dtype", [
    (1, 512, 16, 192, 128, torch.bfloat16),   # deepseek-v2-lite: D 256
    (1, 256, 40, 96, 64, torch.bfloat16),     # minicpm3: D 128
    (2, 100, 4, 24, 16, torch.float32),       # their reduced configs: D 32
])
def test_flash_kernels_at_the_padded_mla_shapes(cuda, B, S, H, dqk, dv,
                                                dtype):
    """MLA's heads zero-padded to one dispatched head_dim, scale
    1 / sqrt(dqk), through ``ops.flash_attention``: the output cut to dv
    and the gradients equal the unpadded plain attention's (f32, on the
    card), and the pad's columns come back zero."""
    from repro_torch.models import layers
    D = fa.padded_head_dim(max(dqk, dv))
    gen = torch.Generator(device=cuda).manual_seed(9)
    mk = lambda d: torch.randn(B, S, H, d, generator=gen, device=cuda).to(
        dtype)
    q, k, v, g = mk(dqk), mk(dqk), mk(dv), mk(dv)
    pad = lambda t: torch.nn.functional.pad(t, (0, D - t.shape[-1]))
    ts = [pad(t).requires_grad_(True) for t in (q, k, v)]
    n = fa.fwd_kernel_layout.launches
    out = ops.flash_attention(*ts, causal=True, scale=dqk ** -0.5)
    assert fa.fwd_kernel_layout.launches == n + 1
    (out[..., :dv].float() * g.float()).sum().backward()
    assert float(out[..., dv:].abs().max()) == 0.0
    ref = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = layers.blockwise_attention(*ref, causal=True)
    (want * g.float()).sum().backward()
    _close(out[..., :dv].detach(), want.detach())
    for t, r, d in zip(ts, ref, (dqk, dqk, dv)):
        assert float(t.grad[..., d:].abs().max()) == 0.0
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(t.grad[..., :d].float(), r.grad,
                                   rtol=rtol, atol=atol * 4)


def test_mla_attention_on_the_card_matches_the_cpu(cuda):
    """deepseek-v2-lite-reduced's MLA layer with the kernels (f32, padded
    24/16 -> 32) on the card against the CPU, output and gradients, with
    one forward and one of each backward kernel launched."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import layers, lm
    cfg = dataclasses.replace(reduced_config("deepseek-v2-lite-16b"),
                              use_pallas=True)
    p = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    up = {k: v[0] for k, v in p["groups"][0][0]["mixer"].items()}
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    res = {}
    for dev in ("cpu", cuda):
        pp = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in up.items()}
        xx = x.detach().to(dev).requires_grad_(True)
        n = (fa.fwd_kernel_layout.launches, fab.compute_dq.launches)
        out = layers.mla_fwd(pp, xx, cfg, positions=torch.arange(
            64, device=dev))
        out.square().sum().backward()
        res[str(dev)] = [out.detach().cpu(), xx.grad.cpu()] + [
            pp[k].grad.cpu() for k in sorted(pp)]
        if dev == cuda:
            assert (fa.fwd_kernel_layout.launches,
                    fab.compute_dq.launches) == (n[0] + 1, n[1] + 1)
    for a, b in zip(res["cpu"], res["cuda"]):
        assert _rel_err(b, a) <= 1e-4


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-4b",
                                  "deepseek-v2-lite-16b"])
def test_serve_engine_on_the_card_syncs_only_in_poll(cuda, arch):
    """A staggered greedy trace on the card with the kernels: ``step()``
    runs under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in
    admission or decode raises), and the outputs equal the CPU engine's
    from the same weights."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, default_geometry
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, device=dev, params=tree_map(
            lambda t: t.to(dev), params), geom=default_geometry(
                num_slots=2, page_size=8, max_context=48))
        ra = eng.submit([3, 1, 4, 1, 5, 9, 2, 6], max_new=6)
        rb = None
        for s in range(40):
            if s == 2:
                rb = eng.submit([2, 7, 1, 8, 2, 8], max_new=6)
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            eng.poll()
            if ra.done and rb is not None and rb.done:
                break
        outs[dev] = (ra.output, rb.output)
    assert outs["cuda"] == outs["cpu"] and len(outs["cpu"][0]) == 6
