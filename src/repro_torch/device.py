"""Device selection, the caching allocator's setting for tenants that
share a card, the device-fault predicate shared by the port's entry
points, and card shares: disjoint partitions of one card's SMs
(:class:`CardShare`, the units of :func:`card_units`), each with a stream
of its own, which ``launch/mesh.make_submeshes`` hands out as submeshes."""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import NamedTuple, Optional, Sequence, Tuple, Union

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


def device_fingerprint(device) -> Tuple:
    """Hashable, stable identity of a device: its type, index and name
    (the counterpart of ``mesh_fingerprint``).  A CUDA device without an
    index is the current one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return ("cuda", int(index), torch.cuda.get_device_name(index))
    return (dev.type, 0 if dev.index is None else int(dev.index), dev.type)


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


# -- card shares: disjoint SM partitions of one card (green contexts) -------
#
# The driver's calls, through ctypes as ``kernels/_build.py`` loads its
# libraries.  A ``CUdevResource`` is 144 bytes (cuda.h: the type, 92 bytes
# of the driver's own, then a 48-byte union whose SM member starts with
# ``smCount``).
_RESOURCE_SM = 1                    # CU_DEV_RESOURCE_TYPE_SM
_GREEN_CTX_DEFAULT_STREAM = 1       # cuGreenCtxCreate's one valid flag
_STREAM_NON_BLOCKING = 1            # cuGreenCtxStreamCreate's


class _DevResource(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint), ("_driver", ctypes.c_ubyte * 92),
                ("sm_count", ctypes.c_uint), ("_union", ctypes.c_ubyte * 44)]


_P = ctypes.POINTER
_DRIVER_CALLS = {
    "cuDeviceGet": [_P(ctypes.c_int), ctypes.c_int],
    "cuDeviceGetDevResource": [ctypes.c_int, _P(_DevResource), ctypes.c_uint],
    "cuDevSmResourceSplitByCount": [ctypes.c_void_p, _P(ctypes.c_uint),
                                    _P(_DevResource), _P(_DevResource),
                                    ctypes.c_uint, ctypes.c_uint],
    "cuDevResourceGenerateDesc": [_P(ctypes.c_void_p), ctypes.c_void_p,
                                  ctypes.c_uint],
    "cuGreenCtxCreate": [_P(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_uint],
    "cuGreenCtxGetDevResource": [ctypes.c_void_p, _P(_DevResource),
                                 ctypes.c_uint],
    "cuGreenCtxStreamCreate": [_P(ctypes.c_void_p), ctypes.c_void_p,
                               ctypes.c_uint, ctypes.c_int],
    "cuGetErrorString": [ctypes.c_int, _P(ctypes.c_char_p)],
}


def _driver() -> ctypes.CDLL:
    """``libcuda`` with the argument types of the calls used here."""
    lib = ctypes.CDLL("libcuda.so.1")
    for name, argtypes in _DRIVER_CALLS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _call(lib: ctypes.CDLL, name: str, *args) -> None:
    code = getattr(lib, name)(*args)
    if code != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(code, ctypes.byref(msg))
        raise RuntimeError(f"{name} failed: CUDA driver error {code} "
                           f"({(msg.value or b'?').decode()}); the card "
                           f"gives no SM partition (green context)")


@functools.lru_cache(maxsize=None)
def _split_units(index: int):
    """Card ``index``'s SMs split once, for the process, into the driver's
    smallest partitions (so every share is cut from one split and two
    shares of other units never hold one SM): (the driver, the device
    handle, the partitions' resources, the SMs of one partition, the SMs
    left over, the card's SMs)."""
    lib = _driver()
    torch.cuda.synchronize(index)       # the primary context is active
    handle = ctypes.c_int()
    _call(lib, "cuDeviceGet", ctypes.byref(handle), index)
    card = _DevResource()
    _call(lib, "cuDeviceGetDevResource", handle, ctypes.byref(card),
          _RESOURCE_SM)
    parts = (_DevResource * card.sm_count)()
    count, rest = ctypes.c_uint(card.sm_count), _DevResource()
    # minCount 1: the driver rounds it up to its own granularity
    _call(lib, "cuDevSmResourceSplitByCount", parts, ctypes.byref(count),
          ctypes.byref(card), ctypes.byref(rest), 0, 1)
    units = parts[:count.value]
    return lib, handle, units, units[0].sm_count, rest.sm_count, \
        card.sm_count


class CardUnits(NamedTuple):
    """How the driver cuts a card into SM partitions: ``count`` units of
    ``unit_sms`` SMs each, ``leftover_sms`` SMs in none of them."""
    count: int
    unit_sms: int
    leftover_sms: int
    total_sms: int


def card_units(device) -> CardUnits:
    """The units of a CUDA device, read from the driver (nothing about
    the card is assumed)."""
    _, _, units, unit_sms, rest, total = _split_units(
        _cuda_device(device).index)
    return CardUnits(len(units), unit_sms, rest, total)


def _cuda_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"a card share needs a CUDA device, not {dev}")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


class CardShare:
    """Units ``units`` of a card's SMs: a green context over exactly
    those SMs and a stream of its own in it (``stream``, a torch
    ``ExternalStream``).

    Work on the stream runs only on the share's SMs, with no context
    made current: torch's products and elementwise kernels and the port's
    kernels take the stream as they take any other.  Memory stays the
    card's one pool, so a tensor the caching allocator gave anywhere on
    the card is read and written there.  The share lives as long as the
    process (the driver releases it at exit).  A failure to build one
    raises; nothing stands in for it."""

    def __init__(self, device, units: Sequence[int]):
        self.device = _cuda_device(device)
        self.units = tuple(units)
        lib, handle, parts, _, _, _ = _split_units(self.device.index)
        if not self.units or any(not 0 <= u < len(parts)
                                 for u in self.units):
            raise ValueError(f"units {self.units} of a card of "
                             f"{len(parts)} units")
        chosen = (_DevResource * len(self.units))(
            *(parts[u] for u in self.units))
        desc = ctypes.c_void_p()
        _call(lib, "cuDevResourceGenerateDesc", ctypes.byref(desc), chosen,
              len(self.units))
        self._ctx = ctypes.c_void_p()
        _call(lib, "cuGreenCtxCreate", ctypes.byref(self._ctx), desc, handle,
              _GREEN_CTX_DEFAULT_STREAM)
        got = _DevResource()
        _call(lib, "cuGreenCtxGetDevResource", self._ctx, ctypes.byref(got),
              _RESOURCE_SM)
        self.sms = got.sm_count
        raw = ctypes.c_void_p()
        _call(lib, "cuGreenCtxStreamCreate", ctypes.byref(raw), self._ctx,
              _STREAM_NON_BLOCKING, 0)
        self.stream = torch.cuda.ExternalStream(raw.value, device=self.device)

    def __repr__(self) -> str:
        return (f"CardShare({self.device}, units={self.units}, "
                f"sms={self.sms})")


@contextlib.contextmanager
def on_share(share: Optional[CardShare]):
    """Run the block on ``share``: its stream becomes torch's current
    stream in the calling thread (every kernel wrapper launches on the
    current stream, ``kernels/_build.stream_of``), after waiting for what
    the caller's stream had queued.  ``None`` (a CPU submesh) runs the
    block as it is."""
    if share is None:
        yield None
        return
    share.stream.wait_stream(torch.cuda.current_stream(share.device))
    with torch.cuda.stream(share.stream):
        yield share.stream
