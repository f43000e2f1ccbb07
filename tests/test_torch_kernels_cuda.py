"""The CUDA attention kernels against their plain versions on the card.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``
Tolerances (atol, rtol) by the output's dtype: 1e-4, 1e-4 for an f32
output (lse, delta, and every output of f32 inputs: f32 FMAs summed in
another order); 5e-3, 2e-2 for a bf16 output (both sides round an f32
result to bf16 at the end).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops

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
