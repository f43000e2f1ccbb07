"""RG-LRU linear recurrence, backward: the Hopper kernel's wrapper and its
plain version (counterpart of ``repro/kernels/rglru_bwd.py``).

    lam_t = dy_t + a_{t+1} * lam_{t+1}   (lam_S = 0)
    db_t  = lam_t
    da_t  = lam_t * h_{t-1}              (h_{-1} = 0)

The kernel (``csrc/rglru.cu``, entry ``rglru_bwd``) replaces the Pallas
``_rglru_bwd_kernel``: the forward's chained scan walked in reverse chunk
order, each tile handing ``a_t * lam_t`` at its first step to the tile
before it.  It takes the forward's output ``h`` itself and reads
``h_{t-1}`` from it, where the JAX op hands its kernel a shifted copy
``y_prev``: the port never makes that copy.

Dispatch: a CPU tensor takes :func:`bwd_plain`; a CUDA tensor launches the
kernel or raises; in a dry run a meta tensor reports its launch's
:func:`rglru_bwd_work` (``_build.meta_launch``).
``bwd_kernel_layout.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru import chain_scratch, check_operands

Tensor = torch.Tensor


def rglru_bwd_work(*, B, S, W) -> Tuple[float, float]:
    """(flops, bytes) of one backward launch: reads a, h, dy and writes
    da, db, all f32 (B, S, W)."""
    n = B * S * W
    return 4.0 * n, 20.0 * n


def bwd_plain(a: Tensor, h: Tensor, dy: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of the kernel, one step at a time in f32.
    Returns (da, db), each (B, S, W) f32."""
    check_operands(a, h, dy)
    a, h, dy = a.float(), h.float(), dy.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1] - 1, -1, -1):
        lam = dy[:, t] + carry
        db[:, t] = lam
        da[:, t] = lam * h[:, t - 1] if t > 0 else 0.0
        carry = a[:, t] * lam
    return da, db


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def bwd_kernel_layout(a: Tensor, h: Tensor, dy: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """a, h (the forward's output), dy: (B, S, W) f32, contiguous.
    Returns (da, db): (B, S, W) f32."""
    check_operands(a, h, dy)
    if a.device.type == "cpu":
        return bwd_plain(a, h, dy)
    B, S, W = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.device.type == "meta":
        _build.meta_launch("rglru_bwd", rglru_bwd_work, B=B, S=S, W=W)
        return da, db
    scratch = chain_scratch(a)
    fn = _build.function("rglru", "rglru_bwd", _ARGTYPES)
    code = fn(a.data_ptr(), h.data_ptr(), dy.data_ptr(), da.data_ptr(),
              db.data_ptr(), scratch.data_ptr(), B, S, W, _build.stream_of(a))
    _build.check("rglru", code)
    bwd_kernel_layout.launches += 1
    return da, db


bwd_kernel_layout.launches = 0
