"""Counted cost of one call: FLOPs, bytes, collectives and memory (the
counterpart of ``repro/analysis/hlo.py``).

The reference parses the compiled program's HLO text, because XLA's own
cost analysis visits a loop body once.  Eager PyTorch has no HLO: each
aten op is a kernel of its own.  So :func:`count` runs the function once
under a ``TorchDispatchMode`` and counts every aten op it dispatches, into
the reference's :class:`CostSummary` (the same fields, plus ``kernels``,
``memory_analysis`` and ``saved_bytes``).  On the meta device nothing is
computed or allocated, so a full-width step is counted on a host with no
card (``launch/dryrun.py``).

Conventions (the reference's, at aten-op granularity):
  * FLOPs: matmuls and convolutions as ``torch.utils.flop_counter``
    counts them (2 * M * N * K a product); an elementwise op (tagged
    ``torch.Tag.pointwise``) 1 a result element; a reduction (tagged
    ``torch.Tag.reduction``) its input's elements.  An op the flop
    registry does not know is decomposed first where it can be, as
    ``FlopCounterMode`` does.
  * Bytes: operand bytes plus result bytes of each aten op, a tensor's
    bytes counting each element it addresses once (a broadcast, stride-0
    dim counts once).  Views and other aliasing ops, ``empty`` and
    metadata queries are free, as the reference's ``FREE_OPS``; an op that
    only overwrites its target (``copy_``, ``fill_``, ``zero_``) does not
    read it.  XLA counts at fusion granularity, where a fusion's interior
    stays on chip; an eager step fuses nothing, so every op's operands and
    results go through device memory and this count is what the card's
    kernels read and write (less what L2 serves on a re-read).
  * The hand-written kernels: on the meta device each kernel's wrapper
    runs its own checks, allocates its outputs and computes nothing; it
    reports the launch (``kernels/_build.meta_launch``) with its work
    from the work function beside it in its kernel module (:data:`WORK`,
    the functions ``chip_smoke.py`` takes its bounds from), which a
    :class:`CostMode` adds here.
  * Collectives: each collective a data group's step dispatches
    (``dist/group.DataGroup``), per rank, by the reference's ring model
    over the size n of the op's process group: an all-reduce
    (``c10d.allreduce_``) moves ``2 (n - 1) / n`` times its payload in
    wire bytes, an all-gather (``c10d._allgather_base_``, ZeRO-1's
    parameters) and a gather (``c10d.gather_``, a checkpoint's) ``(n - 1)
    / n`` times theirs, their payload the gathered result's bytes as the
    reference's ``analysis/hlo.py`` counts an all-gather, an all-to-all
    (``c10d.alltoall_base_``, expert parallelism's exchange over a
    grid's model group) ``(n - 1) / n`` times its input, the part that
    leaves the rank, and a broadcast (``c10d.broadcast_``) its payload
    (:func:`wire_bytes`).  The payload
    counts under ``collective_payload``, the wire bytes under
    ``collective_bytes`` and ``collective_breakdown``, the calls under
    ``collective_counts`` and ``num_collectives``; the operands and
    results count as bytes too, as the reference's HLO count does.  A
    collective over a group of one is never issued.  On the meta device
    (a dry run of one rank of a group, ``launch/dryrun.py``) the group
    reports each collective here instead of running it
    (``dist/group.META_SINKS``).
  * Memory: ``argument_size_in_bytes`` is the storages the call's
    arguments hold (the state and the batch), ``temp_size_in_bytes`` the
    peak of the bytes of the other storages alive during the call, tracked
    by storage; an in-place update of an argument (AdamW's) adds nothing.
    ``saved_bytes`` counts the storages autograd saved for the backward
    (``saved_tensors_hooks``), arguments excepted.  Under the layer
    recompute (``lm``'s ``remat``) a checkpoint's own hooks take the
    place of this count's inside each live repeat, so the repeats report
    what the backward keeps of them instead (``lm.KEPT_SINKS``): each
    repeat's inputs (the (x, aux) carry, the positions and the encoder
    output; a storage once), plus under 'dots' each product output the
    policy keeps.  The recompute runs in the backward under this mode, so
    its FLOPs and bytes are counted, and its tensors in the peak.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import group as group_lib
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import rglru, rglru_bwd, ssd, ssd_bwd
from repro_torch.models import lm

aten = torch.ops.aten

# ops that move no data: allocation without a write, and metadata queries
FREE_OPS = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten._unsafe_view,
    aten.lift_fresh, aten.size, aten.sym_size, aten.stride, aten.sym_stride,
    aten.numel, aten.sym_numel, aten.dim, aten.storage_offset,
    aten.sym_storage_offset, aten.is_contiguous, aten.sym_is_contiguous,
    aten.is_strides_like_format, aten.is_non_overlapping_and_dense,
}
# ops that write their first argument without reading it
WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0          # wire bytes per device
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    per_opcode_flops: Dict[str, float] = field(default_factory=dict)
    num_collectives: int = 0
    bytes_by_site: Dict[str, float] = field(default_factory=dict)
    collective_by_site: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_payload: Dict[str, float] = field(default_factory=dict)
    # the port's own: {kernel: {shape key: {"calls", "flops", "bytes"}}},
    # per call, as counted by the kernels' meta entries
    kernels: Dict[str, Dict[str, Dict[str, float]]] = field(
        default_factory=dict)
    memory_analysis: Dict[str, int] = field(default_factory=dict)
    saved_bytes: float = 0.0

    def top_collectives(self, n: int = 12):
        return sorted(self.collective_by_site.items(),
                      key=lambda kv: -kv[1])[:n]

    def collectives(self) -> Dict[str, Dict[str, float]]:
        keys = (set(self.collective_counts) | set(self.collective_payload)
                | set(self.collective_breakdown))
        return {k: {"count": self.collective_counts.get(k, 0.0),
                    "payload_bytes": self.collective_payload.get(k, 0.0),
                    "wire_bytes": self.collective_breakdown.get(k, 0.0)}
                for k in sorted(keys)}

    def add_flops(self, opcode: str, n: float):
        self.flops += n
        self.per_opcode_flops[opcode] = self.per_opcode_flops.get(opcode, 0.0) + n

    def add_bytes(self, opcode: str, type_str: str, n: float,
                  op_name: str = ""):
        self.bytes += n
        key = f"{opcode} {type_str[:40]} {op_name[:72]}"
        self.bytes_by_site[key] = self.bytes_by_site.get(key, 0.0) + n

    def top_bytes(self, n: int = 15):
        return sorted(self.bytes_by_site.items(), key=lambda kv: -kv[1])[:n]

    def add_collective(self, kind: str, n: int, payload: float,
                       site: str = "") -> None:
        """One collective of ``payload`` bytes over a group of ``n``."""
        wire = wire_bytes(kind, n, payload)
        self.collective_bytes += wire
        self.collective_breakdown[kind] = \
            self.collective_breakdown.get(kind, 0.0) + wire
        self.collective_counts[kind] = \
            self.collective_counts.get(kind, 0.0) + 1
        self.collective_payload[kind] = \
            self.collective_payload.get(kind, 0.0) + payload
        key = f"{kind} {site}"
        self.collective_by_site[key] = \
            self.collective_by_site.get(key, 0.0) + wire
        self.num_collectives += 1

    def add_kernel(self, name: str, shape: Dict[str, Any],
                   work: Tuple[float, float]) -> None:
        """One launch of kernel ``name`` at ``shape`` (its work function's
        arguments) doing ``work`` = (flops, bytes)."""
        flops, nbytes = work
        self.add_flops(name, flops)
        self.add_bytes(name, "", nbytes)
        ent = self.kernels.setdefault(name, {}).setdefault(
            shape_key(shape), {"calls": 0, "flops": flops, "bytes": nbytes})
        ent["calls"] += 1

    def kernel_totals(self) -> Dict[str, Dict[str, float]]:
        """{kernel: {"calls", "flops", "bytes"}} summed over its shapes."""
        out = {}
        for name, by in self.kernels.items():
            calls = [e["calls"] for e in by.values()]
            out[name] = {"calls": sum(calls)}
            for k in ("flops", "bytes"):
                out[name][k] = sum(n * e[k] for n, e in zip(calls,
                                                            by.values()))
        return out


def wire_bytes(kind: str, n: int, payload: float) -> float:
    """Wire bytes a device sends for one collective of ``payload`` bytes
    over a group of ``n`` (the reference's ring model,
    ``repro/analysis/hlo.py``)."""
    if kind == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1) * payload
    if kind in ("all-gather", "gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / max(n, 1) * payload
    return payload                      # collective-permute, broadcast


def shape_key(shape: Dict[str, Any]) -> str:
    """A kernel call's shape as a stable string key."""
    return ",".join(f"{k}={shape[k]}" for k in sorted(shape))


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses, a stride-0 dim counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# The kernels' work: each kernel module's work function, by kernel name
# (the name ``_build.meta_launch`` reports a launch under)
WORK: Dict[str, Callable[..., Tuple[float, float]]] = {
    "flash_fwd": fa.flash_fwd_work, "flash_delta": fab.flash_delta_work,
    "flash_dq": fab.flash_dq_work, "flash_dkv": fab.flash_dkv_work,
    "ssd_fwd": ssd.ssd_fwd_work, "ssd_fwd_res": ssd.ssd_fwd_res_work,
    "ssd_bwd": ssd_bwd.ssd_bwd_work,
    "rglru_fwd": rglru.rglru_fwd_work, "rglru_bwd": rglru_bwd.rglru_bwd_work,
}


# ---------------------------------------------------------------------------
# The counting mode
# ---------------------------------------------------------------------------

class _Live:
    """Bytes of the storages alive beyond the arguments, and their peak."""

    def __init__(self, arg_keys: Iterable[int]):
        self.arg_keys = set(arg_keys)
        self.refs: Dict[int, List[int]] = {}     # key: [tensors, nbytes]
        self.now = self.peak = 0

    def track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self.arg_keys:
            return
        ent = self.refs.get(key)
        if ent is None:
            ent = self.refs[key] = [0, t.untyped_storage().nbytes()]
            self.now += ent[1]
            self.peak = max(self.peak, self.now)
        ent[0] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self.refs[key]
        ent[0] -= 1
        if not ent[0]:
            del self.refs[key]
            self.now -= ent[1]


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched while active into ``self.summary``;
    ``arguments`` are the tensors whose storages are not temporaries."""

    def __init__(self, arguments=()):
        super().__init__()
        self.summary = CostSummary()
        args = {_storage_key(t): t.untyped_storage().nbytes()
                for t in _tensors(arguments)}
        self.summary.memory_analysis["argument_size_in_bytes"] = sum(
            args.values())
        self._live = _Live(args)
        self._saved: set = set()
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        key = _storage_key(t)
        if key not in self._live.arg_keys and key not in self._saved:
            self._saved.add(key)
            self.summary.saved_bytes += t.untyped_storage().nbytes()
        return t

    def _kept(self, tensors: List[torch.Tensor], nbytes: int) -> None:
        """What a recomputed repeat keeps (``lm.KEPT_SINKS``)."""
        for t in tensors:
            self._pack(t)
        self.summary.saved_bytes += nbytes

    def __enter__(self):
        _build.META_SINKS.append(self.summary.add_kernel)
        group_lib.META_SINKS.append(self.summary.add_collective)
        lm.KEPT_SINKS.append(self._kept)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.__exit__(*exc)
            lm.KEPT_SINKS.remove(self._kept)
            group_lib.META_SINKS.remove(self.summary.add_collective)
            _build.META_SINKS.remove(self.summary.add_kernel)
            self.summary.memory_analysis["temp_size_in_bytes"] = \
                self._live.peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and packet not in FREE_OPS:
            # the decomposed ops dispatch through this mode again
            TorchDispatchMode.__enter__(self)
            try:
                r = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        s = self.summary
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = packet.__name__
        if packet in flop_registry:
            s.add_flops(name, flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            s.add_flops(name, sum(o.numel() for o in outs))
        elif torch.Tag.reduction in func.tags and ins:
            s.add_flops(name, ins[0].numel())
        for o in outs:
            self._live.track(o)
        if func.namespace == "c10d" and name in _COLLECTIVES:
            kind, result, pg = _COLLECTIVES[name]
            tensors = args[result]
            if isinstance(tensors, torch.Tensor):
                tensors = [tensors]
            n = dist.ProcessGroup.unbox(args[pg]).size()
            payload = sum(map(tensor_bytes, tensors))
            if kind == "gather":    # the gathered tensor, on every rank
                payload *= n
            s.add_collective(kind, n, payload,
                             f"{tensors[0].dtype} {tuple(tensors[0].shape)}")
        if packet in FREE_OPS or not outs:
            return
        mutates = any(a.alias_info is not None and a.alias_info.is_write
                      for a in func._schema.arguments)
        if not mutates:     # a view or another alias of an input is free
            keys = {_storage_key(t) for t in ins}
            if all(_storage_key(o) in keys for o in outs):
                return
        if packet in WRITE_ONLY:
            ins = ins[1:]
        s.add_bytes(name, str(tuple(outs[0].shape)),
                    sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs)))


# c10d op -> (kind, the argument whose tensors are the payload, the
# argument that is the process group): the result of an all-gather, what
# a gather sends (times the group's size), the tensors of the others
_COLLECTIVES = {"allreduce_": ("all-reduce", 0, 1),
                "_allgather_base_": ("all-gather", 0, 2),
                "alltoall_base_": ("all-to-all", 1, 2),
                "gather_": ("gather", 1, 2),
                "broadcast_": ("broadcast", 0, 1)}


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, CostSummary]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`CostMode` whose
    arguments are those of the call; returns (its result, the summary)."""
    with CostMode((args, kwargs)) as mode:
        out = fn(*args, **kwargs)
    return out, mode.summary
