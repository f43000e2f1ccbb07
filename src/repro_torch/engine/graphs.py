"""CUDA-graph steps: the port's counterpart of a compiled step-table entry.

A step of the port is a few thousand kernel launches enqueued from Python
(some 3200 for yi-6b's decode step).  :func:`capture` records one such step
into a ``torch.cuda.CUDAGraph`` so that one host call replays them all:

* the caller's ``body`` reads only static buffers (the caller fills its
  inputs with ``copy_`` before each replay) and returns graph-owned
  outputs, which the next replay overwrites;
* an optional ``warmup`` runs first on a side stream, so lazy set-up (the
  kernels' libraries, cuBLAS handles, autograd's device thread) happens
  outside the capture; it must leave the caller's state as it found it;
* every entry of one engine captures into that engine's one memory pool
  (``torch.cuda.graph_pool_handle()``): the entries never run at once;
* a random ``generator`` the body draws from is registered with the
  graph, so each replay draws new numbers, as an eager call does.

The kernel wrappers count their launches in Python (``.launches``), which
a replay does not run; :class:`Graph` records each counter's change during
the capture, takes it back (nothing launched), and adds it on every
replay.  A capture that fails raises: nothing falls back to eager.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

# each launch counter's kernel library (``csrc/<lib>.cu``)
COUNTER_LIBS = {"flash_fwd": "flash_fwd", "flash_delta": "flash_delta",
                "flash_dq": "flash_dq", "flash_dkv": "flash_dkv",
                "ssd_fwd": "ssd_fwd", "ssd_fwd_res": "ssd_fwd",
                "ssd_bwd": "ssd_bwd", "rglru_fwd": "rglru",
                "rglru_bwd": "rglru"}


def launch_counters() -> Dict[str, Callable]:
    """The kernel wrappers, each with its launch count in ``.launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import rglru, rglru_bwd, ssd, ssd_bwd
    return {"flash_fwd": fa.fwd_kernel_layout,
            "flash_delta": fab.compute_delta,
            "flash_dq": fab.compute_dq, "flash_dkv": fab.compute_dkv,
            "ssd_fwd": ssd.ssd_fwd_kernel_layout,
            "ssd_fwd_res": ssd_bwd.fwd_res_kernel_layout,
            "ssd_bwd": ssd_bwd.bwd_kernel_layout,
            "rglru_fwd": rglru.rglru_scan,
            "rglru_bwd": rglru_bwd.bwd_kernel_layout}


def launch_counts() -> Dict[str, int]:
    return {n: fn.launches for n, fn in launch_counters().items()}


class Graph:
    """One captured step: :meth:`replay` runs it and returns its outputs.

    ``launches``: each kernel's launches a replay makes; ``pool_bytes``:
    the device memory the capture added to the pool (reserved, so an
    entry captured after another of the same pool shows only its growth);
    ``peak_bytes``: the allocator's peak during the capture."""

    def __init__(self, graph: torch.cuda.CUDAGraph, outputs: Any,
                 launches: Dict[str, int], pool_bytes: int,
                 peak_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.peak_bytes = peak_bytes

    def replay(self) -> Any:
        self.graph.replay()
        counters = launch_counters()
        for name, n in self.launches.items():
            counters[name].launches += n
        return self.outputs


def capture(body: Callable[[], Any], *, device, pool,
            warmup: Optional[Callable[[], None]] = None,
            generators: Sequence[torch.Generator] = (),
            stream: Optional[torch.cuda.Stream] = None) -> Graph:
    """Capture ``body`` on ``device`` (a CUDA device) into ``pool``.

    ``stream``: a card share's stream (``device.CardShare``), on which the
    warmup runs and the capture is made, so the graph's kernels run on the
    share's SMs.  The capture waits for the whole card and empties the
    allocator's cache, so it is made while no other share's work is in
    flight (``cluster/live.py`` builds tables on arrival, between
    rounds)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    if warmup is not None:
        side = stream if stream is not None else torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream(device).wait_stream(side)
    if stream is not None:
        stream.synchronize()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    counters = launch_counters()
    before = launch_counts()
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool,
                                                        stream=stream):
            outputs = body()
    finally:
        grew = {n: fn.launches - before[n] for n, fn in counters.items()}
        for name, fn in counters.items():
            fn.launches = before[name]      # a capture launches nothing
    return Graph(graph, outputs, {n: c for n, c in grew.items() if c},
                 torch.cuda.memory_reserved(device) - reserved,
                 torch.cuda.max_memory_allocated(device))

