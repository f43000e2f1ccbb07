"""Differentiable ops over the hand-written kernels (counterpart of
``repro/kernels/ops.py``): flash attention, the SSD scan and the RG-LRU
recurrence.

Each op is a ``torch.autograd.Function`` in the ``torch.func`` form
(``forward`` without ``ctx``, ``setup_context``, and a ``vmap``
staticmethod), so it runs eagerly, under ``torch.func.grad`` and under
``torch.func.vmap`` -- the horizontal fusion of ``engine/fused.py``.
Under ``vmap`` the rule moves each input's jobs axis to the front and
folds it into the batch axis (:func:`_fold`), so a kernel is launched
once, at J x B rows, on plain tensors; nothing under a transform reaches
a kernel wrapper, whose ``data_ptr()`` of a wrapped tensor would not be
the batch.  Each backward is a Function of its own with the same rule
(``_FlashAttentionBwd``, ``_SSDBwd``, ``_RGLRUBwd``), so the backward
kernels also see the folded batch.

Flash attention: ``torch.autograd.Function`` takes the place of the JAX
``custom_vjp``: the forward launches the forward kernel with ``lse`` and
saves q, k, v, the output and ``lse``; the backward runs the delta, dq
and dkv kernels.  When no gradient can be needed (grad mode off, or no
input requires grad -- the SPB frozen prefix) a forward-only Function
runs the kernel without ``lse`` and saves nothing.

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


# ---------------------------------------------------------------------------
# The vmap rule: fold the jobs axis into the batch axis
# ---------------------------------------------------------------------------

def _fold(t, in_dim: Optional[int], J: int):
    """``t`` with its jobs axis ``in_dim`` folded into its batch axis:
    (J, B, ...) -> (J*B, ...).  A non-tensor passes unchanged; an input
    with no jobs axis (``in_dim`` None) is expanded over the J jobs.  A
    broadcast dim (stride 0, e.g. SSD's B and C at one group over the
    heads) stays a stride-0 view: where the fold cannot be a view the
    copy holds one row of it, and the result expands it back."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.movedim(in_dim, 0) if in_dim is not None else t.expand(J, *t.shape)
    keep = tuple(slice(0, 1) if i >= 2 and t.stride(i) == 0 else slice(None)
                 for i in range(t.dim()))
    rows = J * t.shape[1]
    return t[keep].reshape(rows, *t[keep].shape[2:]).expand(rows,
                                                            *t.shape[2:])


def _unfold(out, J: int):
    """Split the folded batch axis of every output back into (J, B)."""
    if isinstance(out, tuple):
        return tuple(o.unflatten(0, (J, -1)) for o in out), (0,) * len(out)
    return out.unflatten(0, (J, -1)), 0


def _folding_vmap(fn):
    """A ``vmap`` staticmethod that runs ``fn.apply`` once on the folded
    inputs (every tensor input carries a batch axis at dim 0)."""

    def rule(info, in_dims, *args):
        J = info.batch_size
        return _unfold(fn.apply(*(_fold(a, d, J)
                                  for a, d in zip(args, in_dims))), J)

    return staticmethod(rule)


class _ForwardOnly(torch.autograd.Function):
    """Base of the Functions that never need a backward: the no-grad
    forwards and the backward kernels' own Functions."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(q, k, v, causal: bool, window: int, scale):
        ot, lse = fa.fwd_kernel_layout(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, with_lse=True,
                                       scale=scale)
        return _t(ot), lse

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window, ctx.scale = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)

    @staticmethod
    def backward(ctx, g, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, o, lse, g, ctx.causal,
                                              ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None


class _FlashAttentionFwd(_ForwardOnly):

    @staticmethod
    def forward(q, k, v, causal: bool, window: int, scale):
        return _t(fa.fwd_kernel_layout(_t(q), _t(k), _t(v), causal=causal,
                                       window=window, scale=scale))


class _FlashAttentionBwd(_ForwardOnly):
    """The delta, dq and dkv kernels on the forward's residuals and the
    output's cotangent ``g`` (which may arrive with any strides)."""

    @staticmethod
    def forward(q, k, v, o, lse, g, causal: bool, window: int, scale):
        dq, dk, dv = fab.bwd_kernel_layout(
            _t(q), _t(k), _t(v), _t(o), lse.contiguous(), _t(g.contiguous()),
            causal=causal, window=window, scale=scale)
        return _t(dq), _t(dk), _t(dv)


for _fn in (_FlashAttention, _FlashAttentionFwd, _FlashAttentionBwd):
    _fn.vmap = _folding_vmap(_fn)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_block: int = 128,
                    kv_block: int = 128, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D).  Returns (B, Sq, H, D).
    Scores are scaled by ``scale``, 1 / sqrt(D) when None (MLA passes
    1 / sqrt(dn + dr) for heads zero-padded to D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)[0]
    return _FlashAttentionFwd.apply(q, k, v, causal, window, scale)


# ---------------------------------------------------------------------------
# SSD (Mamba-2) chunked scan
# ---------------------------------------------------------------------------

class _SSD(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``ops._ssd``: the forward runs the
    forward-with-residuals kernel and keeps (x, dA, b, c, chunk_states);
    the backward runs the backward kernel and casts each gradient to its
    input's dtype."""

    @staticmethod
    def forward(x, dA, b, c, chunk: int):
        return _ssd_bwd.fwd_res_kernel_layout(x, dA, b, c, chunk=chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dA, b, c, ctx.chunk = inputs
        chunk_states = output[2]
        ctx.mark_non_differentiable(chunk_states)
        ctx.save_for_backward(x, dA, b, c, chunk_states)

    @staticmethod
    def backward(ctx, dy, dstate, _dchunk_states):
        x, dA, b, c, chunk_states = ctx.saved_tensors
        dx, ddA, db, dc = _SSDBwd.apply(x, dA, b, c, chunk_states, dy,
                                        dstate, ctx.chunk)
        return dx, ddA, db, dc, None


class _SSDFwd(_ForwardOnly):

    @staticmethod
    def forward(x, dA, b, c, chunk: int):
        return _ssd.ssd_fwd_kernel_layout(x, dA, b, c, chunk=chunk)


class _SSDBwd(_ForwardOnly):

    @staticmethod
    def forward(x, dA, b, c, chunk_states, dy, dstate, chunk: int):
        # autograd materializes an unused output's gradient as zeros; dy
        # may arrive broadcast (stride 0), the kernel reads unit-stride rows
        dx, ddA, db, dc = _ssd_bwd.bwd_kernel_layout(
            x, dA, b, c, chunk_states, dy.float().contiguous(),
            dstate.float(), chunk=chunk)
        return (dx.to(x.dtype), ddA.to(dA.dtype), db.to(b.dtype),
                dc.to(c.dtype))


for _fn in (_SSD, _SSDFwd, _SSDBwd):
    _fn.vmap = _folding_vmap(_fn)


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
        y, state, _ = _SSD.apply(xdt, dA, B_, C, Q)
        return y, state
    return _SSDFwd.apply(xdt, dA, B_, C, Q)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin) linear recurrence
# ---------------------------------------------------------------------------

class _RGLRU(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``ops._rglru``: the forward runs the scan
    and keeps (a, h); the backward runs the reverse-scan kernel on h itself
    (no shifted copy) and returns da, db in a's dtype."""

    @staticmethod
    def forward(a, b):
        return _rglru.rglru_scan(a.contiguous(), b.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return _RGLRUBwd.apply(a, h, dh)


class _RGLRUFwd(_ForwardOnly):

    @staticmethod
    def forward(a, b):
        return _rglru.rglru_scan(a.contiguous(), b.contiguous())


class _RGLRUBwd(_ForwardOnly):

    @staticmethod
    def forward(a, h, dh):
        da, db = _rglru_bwd.bwd_kernel_layout(
            a.contiguous(), h.contiguous(), dh.float().contiguous())
        return da.to(a.dtype), db.to(a.dtype)


for _fn in (_RGLRU, _RGLRUFwd, _RGLRUBwd):
    _fn.vmap = _folding_vmap(_fn)


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
    return _RGLRUFwd.apply(a, b)
