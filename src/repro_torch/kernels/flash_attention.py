"""Flash-attention forward: the Hopper kernel's wrapper and its plain
version (counterpart of ``repro/kernels/flash_attention.py``).

The kernel (``csrc/flash_fwd.cu``) replaces the Pallas
``_flash_fwd_kernel``: one block per (q tile, batch * head), an online
softmax over the visible kv tiles, and ``lse = m + log l`` written only
when asked for.  bf16 runs its products on the tensor cores (wgmma),
f32 as f32 FMAs.  Its source note says what bounds it on the card.

Dispatch: a CPU tensor takes :func:`fwd_plain`; a CUDA tensor launches the
kernel or raises.  Nothing falls back to the plain version on the card.
``fwd_kernel_layout.launches`` counts kernel launches.  In a dry run a
meta tensor passes the same checks and reports its launch's
:func:`flash_fwd_work` (``_build.meta_launch``).

Masking follows the Pallas conventions: masked scores are ``NEG_INF``
(-1e30), the row max starts at ``NEG_INF``, masked probabilities are 0 and
the row sum is clamped at 1e-30, so a fully masked row yields 0 and
``lse ~ -1e30``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head_dim -> the dtypes the kernels take there: at 256 (recurrentgemma-2b)
# only bf16, whose operand tiles fit in shared memory (csrc/flash_common.cuh)
_HEAD_DIMS = {16: tuple(_DTYPES), 32: tuple(_DTYPES), 64: tuple(_DTYPES),
              128: tuple(_DTYPES), 256: (torch.bfloat16,)}


def pair_mask(Sq: int, Sk: int, causal: bool, window: int, device,
              q_start: int = 0, k_start: int = 0) -> torch.Tensor:
    """(Sq, Sk) visibility of the (q, k) pairs of a tile whose first row
    and column sit at ``q_start`` and ``k_start`` (Pallas ``pair_mask``)."""
    qpos = q_start + torch.arange(Sq, device=device)[:, None]
    kpos = k_start + torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def check_layout(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                 *others: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """Validate kernel-layout operands: qt (B, H, Sq, D), kt/vt
    (B, K, Sk, D), one dtype and device, unit stride on D.  Returns
    (B, H, K, Sq, Sk, D)."""
    if qt.dim() != 4 or kt.dim() != 4 or kt.shape != vt.shape:
        raise ValueError(f"expected qt (B,H,Sq,D) and kt/vt (B,K,Sk,D), got "
                         f"{tuple(qt.shape)}, {tuple(kt.shape)}, "
                         f"{tuple(vt.shape)}")
    B, H, Sq, D = qt.shape
    K, Sk = kt.shape[1], kt.shape[2]
    if kt.shape[0] != B or kt.shape[3] != D or K == 0 or H % K:
        raise ValueError(f"incompatible q/k shapes {tuple(qt.shape)} "
                         f"{tuple(kt.shape)}")
    for t in (kt, vt) + others:
        if t.dtype != qt.dtype or t.device != qt.device:
            raise ValueError("attention operands must share dtype and device")
    for t in (qt, kt, vt) + others:
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit stride on D")
    return B, H, K, Sq, Sk, D


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The (q, k) pairs :func:`pair_mask` lets in."""
    n = 0
    for q in range(Sq):
        hi = min(q, Sk - 1) if causal else Sk - 1
        lo = max(0, q - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


def flash_fwd_work(*, B, H, K, Sq, Sk, dqk, dv, causal, window, itemsize,
                   with_lse=True) -> Tuple[float, float]:
    """(flops, bytes) of one forward launch: S = Q K^T and O = P V over
    the visible pairs; reads q, k, v, writes o and (with ``with_lse``) the
    f32 lse.  ``dqk`` and ``dv`` are the score and value head dims."""
    pairs = visible_pairs(Sq, Sk, causal, window) * B * H
    nbytes = itemsize * (B * Sq * H * (dqk + dv) + B * Sk * K * (dqk + dv))
    return 2.0 * (dqk + dv) * pairs, nbytes + (4 * B * H * Sq if with_lse
                                               else 0)


def padded_head_dim(need: int) -> int:
    """The smallest head_dim the kernels dispatch that holds ``need``
    columns: MLA's attention pads its (dn + dr, dv) heads to it with zeros
    (``models/layers._mla_attention``)."""
    for d in sorted(_HEAD_DIMS):
        if d >= need:
            return d
    raise ValueError(f"no attention kernel holds a head_dim of {need}; the "
                     f"kernels take {sorted(_HEAD_DIMS)}")


def softmax_scale(D: int, scale: Optional[float]) -> float:
    """The score scale: ``scale`` when given, else 1 / sqrt(D)."""
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def kernel_dtype_code(qt: torch.Tensor, D: int) -> int:
    """The kernels' dtype code; raises for what they do not take (on the
    meta device, what they would not)."""
    _build.kernel_device(qt, "attention")
    if qt.dtype not in _HEAD_DIMS.get(D, ()):
        raise ValueError(f"attention kernels take float32/bfloat16 with "
                         f"head_dim in (16, 32, 64, 128) and bfloat16 at "
                         f"head_dim 256, got {qt.dtype}, D={D}")
    return _DTYPES[qt.dtype]


def check_aligned(*ts: torch.Tensor) -> None:
    """The bf16 tensor-core kernels, and the delta kernel in both dtypes,
    copy 16-byte chunks: each operand's data must start 16-byte aligned
    and its batch, head and sequence strides be multiples of 16 bytes
    (8 bf16 or 4 f32 elements).  Raises otherwise."""
    for t in ts:
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{t.dtype} attention operands need 16-byte "
                             f"aligned data and batch/head/sequence strides "
                             f"that are multiples of {vec}")


def strides(t: torch.Tensor):
    """Batch, head and sequence strides of a kernel-layout tensor."""
    return t.stride(0), t.stride(1), t.stride(2)


def empty_kernel_layout(B: int, heads: int, S: int, D: int, like: torch.Tensor
                        ) -> torch.Tensor:
    """(B, heads, S, D) output whose transpose to (B, S, heads, D) is
    contiguous, so the public layout costs no copy."""
    return torch.empty((B, S, heads, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def fwd_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, *,
              causal: bool = True, window: int = 0, with_lse: bool = False,
              scale: Optional[float] = None):
    """Plain version of the forward kernel, f32 math on the whole score
    matrix, scores times ``scale`` (1 / sqrt(D) when None).  Returns ot
    (B, H, Sq, D) in qt's dtype, plus lse (B, H, Sq) f32 when
    ``with_lse``."""
    B, H, K, Sq, Sk, D = check_layout(qt, kt, vt)
    G = H // K
    q = qt.float().reshape(B, K, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", q, kt.float()) * softmax_scale(
        D, scale)
    mask = pair_mask(Sq, Sk, causal, window, qt.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, vt.float()) / l
    ot = o.reshape(B, H, Sq, D).to(qt.dtype)
    if with_lse:
        return ot, (m + torch.log(l))[..., 0].reshape(B, H, Sq)
    return ot


_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
                 + [ctypes.c_float, ctypes.c_void_p])


def fwd_kernel_layout(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      with_lse: bool = False, scale: Optional[float] = None):
    """Forward in kernel layout.  qt: (B, H, Sq, D); kt, vt: (B, K, Sk, D).
    Scores are scaled by ``scale`` (1 / sqrt(D) when None).  Returns ot,
    or (ot, lse) when ``with_lse``."""
    B, H, K, Sq, Sk, D = check_layout(qt, kt, vt)
    if qt.device.type == "cpu":
        return fwd_plain(qt, kt, vt, causal=causal, window=window,
                         with_lse=with_lse, scale=scale)
    dtype = kernel_dtype_code(qt, D)
    if qt.dtype == torch.bfloat16:
        check_aligned(qt, kt, vt)
    ot = empty_kernel_layout(B, H, Sq, D, qt)
    lse: Optional[torch.Tensor] = (
        torch.empty((B, H, Sq), dtype=torch.float32, device=qt.device)
        if with_lse else None)
    if qt.device.type == "meta":
        _build.meta_launch("flash_fwd", flash_fwd_work, B=B, H=H, K=K, Sq=Sq,
                           Sk=Sk, dqk=D, dv=D, causal=causal, window=window,
                           itemsize=qt.element_size(), with_lse=with_lse)
        return (ot, lse) if with_lse else ot
    fn = _build.function("flash_fwd", "flash_fwd", _FWD_ARGTYPES)
    code = fn(dtype, D, qt.data_ptr(), kt.data_ptr(), vt.data_ptr(),
              ot.data_ptr(), lse.data_ptr() if lse is not None else None,
              B, H, K, Sq, Sk, *strides(qt), *strides(kt), *strides(vt),
              *strides(ot), int(causal), int(window), softmax_scale(D, scale),
              _build.stream_of(qt))
    _build.check("flash_fwd", code)
    fwd_kernel_layout.launches += 1
    return (ot, lse) if with_lse else ot


fwd_kernel_layout.launches = 0
