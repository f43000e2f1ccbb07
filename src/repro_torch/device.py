"""Device selection, the caching allocator's setting for tenants that
share a card, and the device-fault predicate shared by the port's entry
points."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch

from repro_torch.kernels._build import KernelError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Asking for a card where there is none raises; nothing
    quietly falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


def device_fault(e: BaseException) -> bool:
    """A kernel's or the card's own fault: not transient, and a CUDA
    context that took an illegal access cannot be recovered within the
    process, so a restart or a retry would only hide it."""
    faults = (KernelError, torch.cuda.OutOfMemoryError) + tuple(
        t for t in (getattr(torch, "AcceleratorError", None),) if t)
    return isinstance(e, faults) or "CUDA error" in str(e)


def share_card() -> None:
    """Give the caching allocator expandable segments, for sessions whose
    tenants take turns on one card (``cluster/live.py``).

    With fixed-size segments, two tenants whose steps peak at different
    shapes leave free blocks that fit neither, and a warm step then maps
    new segments mid-step (``cudaMalloc``, tens of ms) or frees them all and
    retries near capacity.  An expandable segment grows in place instead,
    so the blocks a step frees fit the next.  Takes effect for segments
    mapped from now on; the cached ones are released first.  A setting the
    user gave in ``PYTORCH_CUDA_ALLOC_CONF`` is kept."""
    if "expandable_segments" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""):
        return
    setting = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    setting("expandable_segments:True")
