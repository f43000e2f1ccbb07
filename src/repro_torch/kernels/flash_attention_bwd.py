"""FlashAttention-2 backward: the three Hopper kernels' wrappers and their
plain versions (counterpart of ``repro/kernels/flash_attention_bwd.py``).

  * :func:`compute_delta` -- ``delta = rowsum(dO * O)`` (``csrc/flash_delta.cu``,
    replaces ``_delta_kernel``; a stream of 16-byte loads, templated on
    the dtype and head_dim);
  * :func:`compute_dq` -- dQ over the visible kv tiles
    (``csrc/flash_dq.cu``, replaces ``_dq_kernel``; in bf16 on the tensor
    cores);
  * :func:`compute_dkv` -- dK, dV per kv head, summed over the GQA group's
    q heads and the visible q tiles and written once
    (``csrc/flash_dkv.cu``, replaces ``_dkv_kernel``; in bf16 on the
    tensor cores, its q heads split over :func:`dkv_head_splits` blocks
    whose f32 partial sums a second kernel adds in a fixed order, in the
    same call).

All three recompute ``P = exp(S - lse)`` from the forward's logsumexp; no
(Sq, Sk) matrix reaches device memory.  Dispatch as in the forward: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises, and in a dry run a meta tensor reports its launch's work
(``*_work`` below, ``_build.meta_launch``).  Each wrapper counts its
launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (check_aligned, check_layout,
                                                 empty_kernel_layout,
                                                 kernel_dtype_code,
                                                 pair_mask, softmax_scale,
                                                 strides, visible_pairs)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Plain versions (f32 math on the whole score matrix)
# ---------------------------------------------------------------------------

def delta_plain(ot: Tensor, dot_: Tensor) -> Tensor:
    return (ot.float() * dot_.float()).sum(dim=-1)


def _probs_and_ds(qt, kt, vt, dot_, lse, delta, causal, window, scale):
    """P and dS, (B, K, G, Sq, Sk) f32, with dS = P (dP - delta) * scale
    (1 / sqrt(D) when ``scale`` is None)."""
    B, H, K, Sq, Sk, D = check_layout(qt, kt, vt, dot_)
    G = H // K
    scale = softmax_scale(D, scale)
    q = qt.float().reshape(B, K, G, Sq, D)
    do = dot_.float().reshape(B, K, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", q, kt.float()) * scale
    mask = pair_mask(Sq, Sk, causal, window, qt.device)
    p = torch.exp(s - lse.reshape(B, K, G, Sq, 1)).masked_fill(~mask, 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", do, vt.float())
    ds = p * (dp - delta.reshape(B, K, G, Sq, 1)) * scale
    return p, ds, q, do


def dq_plain(qt, kt, vt, dot_, lse, delta, *, causal=True, window=0,
             scale: Optional[float] = None) -> Tensor:
    B, H, Sq, D = qt.shape
    _, ds, _, _ = _probs_and_ds(qt, kt, vt, dot_, lse, delta, causal, window,
                                scale)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kt.float())
    return dq.reshape(B, H, Sq, D).to(qt.dtype)


def dkv_plain(qt, kt, vt, dot_, lse, delta, *, causal=True, window=0,
              scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    p, ds, q, do = _probs_and_ds(qt, kt, vt, dot_, lse, delta, causal, window,
                                 scale)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do)
    return dk.to(kt.dtype), dv.to(vt.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DELTA_ARGTYPES = [_I] + [_P] * 3 + [_I] * 4 + [_L] * 6 + [_P]
_DQ_ARGTYPES = ([_I] * 2 + [_P] * 7 + [_I] * 5 + [_L] * 15 + [_I] * 2
                + [ctypes.c_float, _P])
_DKV_ARGTYPES = ([_I] * 2 + [_P] * 9 + [_I] * 6 + [_L] * 18 + [_I] * 2
                 + [ctypes.c_float, _P])


def dkv_head_splits(B: int, K: int, G: int, Sk: int, D: int, sms: int
                    ) -> int:
    """Over how many blocks the bf16 dkv kernel splits each GQA group's
    ``G`` q heads.

    A block walks a pair of 64-row kv tiles (j and nk - 1 - j, equal work
    under causality) for its share of the heads, so the grid holds
    ``ceil(nk / 2) * B * K * splits`` blocks of ``G / splits`` heads each;
    ``sms`` SMs hold one block each at D 256 and two below.  The cost of
    a split is the head-walks on the busiest slot,
    ``ceil(blocks / slots) * G / splits``.  A split above 1 costs f32
    scratch of ``splits * 2 * B * K * Sk * D`` and a reduction pass, so
    this takes the smallest divisor of ``G`` whose cost is within a
    quarter of the least."""
    pairs = (-(-Sk // 64) + 1) // 2
    slots = sms * (1 if D > 128 else 2)
    divisors = [s for s in range(1, G + 1) if G % s == 0]
    cost = {s: -(-(pairs * B * K * s) // slots) * (G // s) for s in divisors}
    least = min(cost.values())
    return next(s for s in divisors if cost[s] <= 1.25 * least)


def flash_delta_work(*, B, H, Sq, dv, itemsize) -> Tuple[float, float]:
    """(flops, bytes) of one delta launch: rowsum(dO * O) reads o and dO
    and writes the f32 delta."""
    return 2.0 * B * H * Sq * dv, 2 * itemsize * B * H * Sq * dv + 4 * B * H * Sq


def _bwd_io(B, H, K, Sq, Sk, dqk, dv, itemsize) -> int:
    """q, k, v, dO and the f32 lse and delta, read by dq and by dkv."""
    return (itemsize * (B * Sq * H * (dqk + dv) + B * Sk * K * (dqk + dv))
            + 2 * 4 * B * H * Sq)


def flash_dq_work(*, B, H, K, Sq, Sk, dqk, dv, causal, window, itemsize
                  ) -> Tuple[float, float]:
    """(flops, bytes) of one dq launch: the S and dS Q-side products
    (2 x qk) and dP = dO V^T (pv) over the visible pairs; writes dq."""
    pairs = visible_pairs(Sq, Sk, causal, window) * B * H
    return (2.0 * pairs * (2 * dqk + dv),
            _bwd_io(B, H, K, Sq, Sk, dqk, dv, itemsize)
            + itemsize * B * Sq * H * dqk)


def flash_dkv_work(*, B, H, K, Sq, Sk, dqk, dv, causal, window, itemsize
                   ) -> Tuple[float, float]:
    """(flops, bytes) of one dkv launch: S, dK = dS^T Q (2 x qk), dP and
    dV = P^T dO (2 x pv) over the visible pairs; writes dk and dv."""
    pairs = visible_pairs(Sq, Sk, causal, window) * B * H
    return (2.0 * pairs * (2 * dqk + 2 * dv),
            _bwd_io(B, H, K, Sq, Sk, dqk, dv, itemsize)
            + itemsize * B * Sk * K * (dqk + dv))


def _check_rows(lse: Tensor, delta: Tensor, B: int, H: int, Sq: int) -> None:
    for t in (lse, delta):
        if (t.shape != (B, H, Sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("lse/delta must be contiguous (B, H, Sq) f32")


def compute_delta(ot: Tensor, dot_: Tensor) -> Tensor:
    """delta (B, H, Sq) f32 from ot, dot_ (B, H, Sq, D).  On the card both
    need 16-byte aligned data and strides (:func:`check_aligned`)."""
    if ot.shape != dot_.shape or ot.dtype != dot_.dtype:
        raise ValueError("ot and dot_ must match in shape and dtype")
    if ot.stride(-1) != 1 or dot_.stride(-1) != 1:
        raise ValueError("delta operands need a unit stride on D")
    if ot.device.type == "cpu":
        return delta_plain(ot, dot_)
    B, H, Sq, D = ot.shape
    dtype = kernel_dtype_code(ot, D)
    check_aligned(ot, dot_)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=ot.device)
    if ot.device.type == "meta":
        _build.meta_launch("flash_delta", flash_delta_work, B=B, H=H, Sq=Sq,
                           dv=D, itemsize=ot.element_size())
        return delta
    fn = _build.function("flash_delta", "flash_delta", _DELTA_ARGTYPES)
    code = fn(dtype, ot.data_ptr(), dot_.data_ptr(), delta.data_ptr(), B, H,
              Sq, D, *strides(ot), *strides(dot_), _build.stream_of(ot))
    _build.check("flash_delta", code)
    compute_delta.launches += 1
    return delta


def compute_dq(qt, kt, vt, dot_, lse, delta, *, causal=True, window=0,
               scale: Optional[float] = None) -> Tensor:
    """dq (B, H, Sq, D) in qt's dtype; ``scale`` as the forward's."""
    B, H, K, Sq, Sk, D = check_layout(qt, kt, vt, dot_)
    _check_rows(lse, delta, B, H, Sq)
    if qt.device.type == "cpu":
        return dq_plain(qt, kt, vt, dot_, lse, delta, causal=causal,
                        window=window, scale=scale)
    dtype = kernel_dtype_code(qt, D)
    if qt.dtype == torch.bfloat16:
        check_aligned(qt, kt, vt, dot_)
    dq = empty_kernel_layout(B, H, Sq, D, qt)
    if qt.device.type == "meta":
        _build.meta_launch("flash_dq", flash_dq_work, B=B, H=H, K=K, Sq=Sq,
                           Sk=Sk, dqk=D, dv=D, causal=causal, window=window,
                           itemsize=qt.element_size())
        return dq
    fn = _build.function("flash_dq", "flash_dq", _DQ_ARGTYPES)
    code = fn(dtype, D, qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
              dot_.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), B, H, K, Sq, Sk, *strides(qt), *strides(kt),
              *strides(vt), *strides(dot_), *strides(dq), int(causal),
              int(window), softmax_scale(D, scale), _build.stream_of(qt))
    _build.check("flash_dq", code)
    compute_dq.launches += 1
    return dq


def compute_dkv(qt, kt, vt, dot_, lse, delta, *, causal=True, window=0,
                scale: Optional[float] = None) -> Tuple[Tensor, Tensor]:
    """(dk, dv), each (B, K, Sk, D) in kt's dtype; ``scale`` as the
    forward's."""
    B, H, K, Sq, Sk, D = check_layout(qt, kt, vt, dot_)
    _check_rows(lse, delta, B, H, Sq)
    if qt.device.type == "cpu":
        return dkv_plain(qt, kt, vt, dot_, lse, delta, causal=causal,
                         window=window, scale=scale)
    dtype = kernel_dtype_code(qt, D)
    dk = empty_kernel_layout(B, K, Sk, D, kt)
    dv = empty_kernel_layout(B, K, Sk, D, vt)
    splits, part = 1, None
    if qt.dtype == torch.bfloat16:
        check_aligned(qt, kt, vt, dot_)
    if qt.device.type == "meta":
        _build.meta_launch("flash_dkv", flash_dkv_work, B=B, H=H, K=K, Sq=Sq,
                           Sk=Sk, dqk=D, dv=D, causal=causal, window=window,
                           itemsize=qt.element_size())
        return dk, dv
    if qt.dtype == torch.bfloat16:
        splits = dkv_head_splits(
            B, K, H // K, Sk, D,
            torch.cuda.get_device_properties(qt.device).multi_processor_count)
        if splits > 1:      # f32 partial sums, reduced inside the call
            part = torch.empty((splits, 2, B, K, Sk, D), dtype=torch.float32,
                               device=qt.device)
    fn = _build.function("flash_dkv", "flash_dkv", _DKV_ARGTYPES)
    code = fn(dtype, D, qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
              dot_.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dk.data_ptr(), dv.data_ptr(),
              part.data_ptr() if part is not None else None, splits,
              B, H, K, Sq, Sk, *strides(qt),
              *strides(kt), *strides(vt), *strides(dot_), *strides(dk),
              *strides(dv), int(causal), int(window), softmax_scale(D, scale),
              _build.stream_of(qt))
    _build.check("flash_dkv", code)
    compute_dkv.launches += 1
    return dk, dv


compute_delta.launches = 0
compute_dq.launches = 0
compute_dkv.launches = 0


def bwd_kernel_layout(qt, kt, vt, ot, lse, dot_, *, causal=True, window=0,
                      scale: Optional[float] = None):
    """Backward in kernel layout; returns (dqt, dkt, dvt)."""
    delta = compute_delta(ot, dot_)
    dq = compute_dq(qt, kt, vt, dot_, lse, delta, causal=causal,
                    window=window, scale=scale)
    dk, dv = compute_dkv(qt, kt, vt, dot_, lse, delta, causal=causal,
                         window=window, scale=scale)
    return dq, dk, dv
