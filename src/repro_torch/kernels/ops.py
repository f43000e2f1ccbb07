"""Differentiable flash attention over the hand-written kernels
(counterpart of ``repro/kernels/ops.py``'s flash-attention op).

``torch.autograd.Function`` takes the place of the JAX ``custom_vjp``: the
forward launches the forward kernel with ``lse`` and saves the residuals as
kernel-layout (B, H, S, D) views plus ``lse``; the backward runs the
delta, dq and dkv kernels.  When no gradient can be needed (grad mode off,
or no input requires grad -- the SPB frozen prefix) the forward runs
without ``lse`` and saves nothing.

The kernels tile at 64 x 64 and mask ragged edges, so ``q_block`` and
``kv_block`` are accepted only to mirror the JAX op's signature and are
ignored; the shape gate that picks this op lives in
``models/layers._pallas_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)            # (B,S,H,D) <-> (B,H,S,D), a view


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        qt, kt, vt = _t(q), _t(k), _t(v)
        ot, lse = fa.fwd_kernel_layout(qt, kt, vt, causal=causal,
                                       window=window, with_lse=True)
        ctx.save_for_backward(qt, kt, vt, ot, lse)
        ctx.causal, ctx.window = causal, window
        return _t(ot)

    @staticmethod
    def backward(ctx, g):
        qt, kt, vt, ot, lse = ctx.saved_tensors
        dq, dk, dv = fab.bwd_kernel_layout(
            qt, kt, vt, ot, lse, _t(g.contiguous()), causal=ctx.causal,
            window=ctx.window)
        return _t(dq), _t(dk), _t(dv), None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_block: int = 128,
                    kv_block: int = 128) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D).  Returns (B, Sq, H, D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _t(fa.fwd_kernel_layout(_t(q), _t(k), _t(v), causal=causal,
                                   window=window))
