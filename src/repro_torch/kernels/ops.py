"""Differentiable ops over the hand-written kernels (counterpart of
``repro/kernels/ops.py``): flash attention, the SSD scan and the RG-LRU
recurrence.

Flash attention:

``torch.autograd.Function`` takes the place of the JAX ``custom_vjp``: the
forward launches the forward kernel with ``lse`` and saves the residuals as
kernel-layout (B, H, S, D) views plus ``lse``; the backward runs the
delta, dq and dkv kernels.  When no gradient can be needed (grad mode off,
or no input requires grad -- the SPB frozen prefix) the forward runs
without ``lse`` and saves nothing.

The kernels tile at 64 x 64 and mask ragged edges, so ``q_block`` and
``kv_block`` are accepted only to mirror the JAX op's signature and are
ignored: on the card ``models/layers.attention_fwd`` always takes this op
when ``cfg.use_pallas`` is set.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import rglru_bwd as _rglru_bwd
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import ssd_bwd as _ssd_bwd


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)            # (B,S,H,D) <-> (B,H,S,D), a view


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale):
        qt, kt, vt = _t(q), _t(k), _t(v)
        ot, lse = fa.fwd_kernel_layout(qt, kt, vt, causal=causal,
                                       window=window, with_lse=True,
                                       scale=scale)
        ctx.save_for_backward(qt, kt, vt, ot, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return _t(ot)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        dq, dk, dv = fab.bwd_kernel_layout(
            qt, kt, vt, ot, lse, _t(g.contiguous()), causal=ctx.causal,
            window=ctx.window, scale=ctx.scale)
        return _t(dq), _t(dk), _t(dv), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_block: int = 128,
                    kv_block: int = 128, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D).  Returns (B, Sq, H, D).
    Scores are scaled by ``scale``, 1 / sqrt(D) when None (MLA passes
    1 / sqrt(dn + dr) for heads zero-padded to D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _t(fa.fwd_kernel_layout(_t(q), _t(k), _t(v), causal=causal,
                                   window=window, scale=scale))


# ---------------------------------------------------------------------------
# SSD (Mamba-2) chunked scan
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``ops._ssd``: the forward runs the
    forward-with-residuals kernel and keeps (x, dA, b, c, chunk_states);
    the backward runs the backward kernel and casts each gradient to its
    input's dtype."""

    @staticmethod
    def forward(ctx, x, dA, b, c, chunk: int):
        y, state, chunk_states = _ssd_bwd.fwd_res_kernel_layout(
            x, dA, b, c, chunk=chunk)
        ctx.save_for_backward(x, dA, b, c, chunk_states)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        # autograd materializes an unused output's gradient as zeros; dy
        # may arrive broadcast (stride 0), the kernel reads unit-stride rows
        x, dA, b, c, chunk_states = ctx.saved_tensors
        dx, ddA, db, dc = _ssd_bwd.bwd_kernel_layout(
            x, dA, b, c, chunk_states, dy.float().contiguous(),
            dstate.float(), chunk=ctx.chunk)
        return (dx.to(x.dtype), ddA.to(dA.dtype), db.to(b.dtype),
                dc.to(c.dtype), None)


def ssd(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 128):
    """Differentiable chunked SSD scan.  xdt: (B, S, H, P); dA: (B, S, H);
    B_, C: (B, S, H, N), views with any strides (a head stride of 0
    broadcasts one group over heads).  The chunk is ``min(chunk, S)``; a
    ragged tail is a short last chunk, the JAX op's zero padding.  dA runs
    in float32 (its gradient returns in its own dtype).
    Returns (y: (B, S, H, P) f32, final_state: (B, H, P, N) f32).

    Outside grad mode, or when no input requires grad (the SPB frozen
    prefix), the primal forward kernel runs and nothing is kept."""
    Q = min(chunk, xdt.shape[1])
    dA = dA.float()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, dA, B_, C)):
        return _SSD.apply(xdt, dA, B_, C, Q)
    return _ssd.ssd_fwd_kernel_layout(xdt, dA, B_, C, chunk=Q)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin) linear recurrence
# ---------------------------------------------------------------------------

class _RGLRU(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``ops._rglru``: the forward runs the scan
    and keeps (a, h); the backward runs the reverse-scan kernel on h itself
    (no shifted copy) and returns da, db in a's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        h = _rglru.rglru_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        da, db = _rglru_bwd.bwd_kernel_layout(a, h, dh.float().contiguous())
        return da.to(a.dtype), db.to(a.dtype)


def rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable RG-LRU scan h_t = a_t h_{t-1} + b_t.  a, b: (B, S, W)
    (float32 on the card).  Returns h: (B, S, W) f32.  Any S and W work:
    the kernels' chained scan masks its last chunk and strip itself, so the
    JAX op's (a=1, b=0) padding to a whole chunk, and its ``chunk`` and
    ``width_block``, have no counterpart.

    Outside grad mode, or when no input requires grad (the SPB frozen
    prefix), the same scan kernel runs and nothing is kept."""
    a, b = a.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RGLRU.apply(a, b)
    return _rglru.rglru_scan(a, b)
