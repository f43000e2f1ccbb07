"""RG-LRU linear recurrence, forward: the Hopper kernel's wrapper and its
plain version (counterpart of ``repro/kernels/rglru.py``).

    h_t = a_t * h_{t-1} + b_t,  h_{-1} = 0,  over (B, S, W) float32

The kernel (``csrc/rglru.cu``, entry ``rglru_fwd``) replaces the Pallas
``_rglru_kernel``: a single-pass chained scan over tiles of (b, 32
channels, 128 steps), all in parallel, each handing its chunk's carry to
the next through a zeroed per-launch scratch (:func:`chain_scratch`).
Any S and W work; the Pallas ``chunk`` and ``width_block`` have no
counterpart.  Its source note says what bounds it.

Dispatch: a CPU tensor takes :func:`rglru_plain`; a CUDA tensor launches
the kernel or raises; in a dry run a meta tensor passes the same checks
and reports its launch's :func:`rglru_fwd_work` (``_build.meta_launch``).
``rglru_scan.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor


def check_operands(*ts: Tensor) -> None:
    """Same (B, S, W) shape and device, contiguous; on the card (and on
    the meta device) float32, the kernels' only dtype."""
    first = ts[0]
    if first.dim() != 3:
        raise ValueError(f"expected (B, S, W) operands, got {tuple(first.shape)}")
    for t in ts:
        if t.shape != first.shape or t.device != first.device:
            raise ValueError("RG-LRU operands must share shape and device")
        if not t.is_contiguous():
            raise ValueError("RG-LRU operands must be contiguous")
    if first.device.type != "cpu":
        _build.kernel_device(first, "RG-LRU")
        if any(t.dtype != torch.float32 for t in ts):
            raise ValueError(f"RG-LRU kernels take float32, got "
                             f"{[str(t.dtype) for t in ts]}")


def rglru_fwd_work(*, B, S, W) -> Tuple[float, float]:
    """(flops, bytes) of one forward launch: h = a h + b over f32
    (B, S, W) reads a, b and writes h."""
    n = B * S * W
    return 2.0 * n, 12.0 * n


def rglru_plain(a: Tensor, b: Tensor) -> Tensor:
    """Plain version of the kernel: the same f32 recurrence, one step at a
    time.  Returns h (B, S, W) f32."""
    check_operands(a, b)
    a, b = a.float(), b.float()
    h = torch.empty_like(a)
    hv = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        hv = a[:, t] * hv + b[:, t]
        h[:, t] = hv
    return h


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def chain_scratch(a: Tensor) -> Tensor:
    """The zeroed scratch one launch of either RG-LRU kernel takes at a's
    (B, S, W): each tile's carry and flag and the tile ticket, allocated
    and zeroed on the current stream for every launch."""
    words = _build.function("rglru", "rglru_scratch_words",
                            [ctypes.c_int] * 3)(*a.shape)
    if words < 0:
        raise ValueError(f"RG-LRU kernels do not take shape {tuple(a.shape)}")
    return torch.zeros(words, dtype=torch.int32, device=a.device)


def rglru_scan(a: Tensor, b: Tensor) -> Tensor:
    """a, b: (B, S, W) f32, contiguous.  Returns h: (B, S, W) f32."""
    check_operands(a, b)
    if a.device.type == "cpu":
        return rglru_plain(a, b)
    B, S, W = a.shape
    h = torch.empty_like(a)
    if a.device.type == "meta":
        _build.meta_launch("rglru_fwd", rglru_fwd_work, B=B, S=S, W=W)
        return h
    scratch = chain_scratch(a)
    fn = _build.function("rglru", "rglru_fwd", _ARGTYPES)
    code = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), scratch.data_ptr(),
              B, S, W, _build.stream_of(a))
    _build.check("rglru", code)
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
