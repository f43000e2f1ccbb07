"""Where a full-width SPB step spends the card's time.

    python -m repro_torch.analysis.step_profile

Runs the chip smoke's full-width configurations one after the other
(``configs.full_width_config``: yi-6b cut to 8 layers, mamba2-2.7b cut
to 32 and recurrentgemma-2b cut to 12, bf16, the hand-written kernels;
temporal SPB k=4, batch 2 x 2048).  For each it warms up one depth
cycle, then traces one step at each depth of the next cycle with
``torch.profiler``.  For each depth it prints the step's host time, the
device's busy time (the union of kernel intervals in the trace), the
idle share, the peak memory, and the kernel time by class: the port's
kernels (four attention, three SSD, two RG-LRU; in bf16 the two SSD
forwards share one class), matrix products, and everything else, with
the largest kernels of the last class.  Needs a card.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b")
# (class, substrings a kernel's name holds): the flash forward, dq and dkv
# classes take their f32 and bf16 (wgmma) kernels, and dkv also the
# reduction pass of its head split; the f32 forward-with-residuals SSD
# walk is the forward template instantiated with RES = true, while the two
# bf16 forwards (ssd_fwd in the frozen prefix, ssd_fwd_res in the suffix)
# share their three chunk-parallel kernels (fwd_u_, fwd_state_ and
# fwd_chunk_kernel), so both land in the ssd_fwd class; the SSD backward
# class takes the f32 reverse walk and the four chunk-parallel bf16
# kernels (bwd_u_, bwd_state_, bwd_chunk_ and bwd_ddA_kernel)
CLASSES = (("flash_fwd", ("flash::fwd_",)),
           ("flash_delta", ("flash::delta_kernel",)),
           ("flash_dq", ("flash::dq_",)),
           ("flash_dkv", ("flash::dkv_",)),
           ("ssd_fwd_res", ("ssd::fwd_kernel", "true>")),
           ("ssd_fwd", ("ssd::fwd_",)),
           ("ssd_bwd", ("ssd::bwd_",)),
           ("rglru_fwd", ("rglru::fwd_kernel",)),
           ("rglru_bwd", ("rglru::bwd_kernel",)))


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if all(k in name for k in keys):
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def trace_kernels(path: str):
    """(name, start_us, dur_us) of every kernel in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel"]


def busy_us(kernels) -> float:
    """Length of the union of the kernels' intervals."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(kernels, key=lambda k: k[1]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def profile(arch: str) -> None:
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine

    cfg = full_width_config(arch)
    spb = SPBConfig(mode="temporal", k=4)
    eng = SPBEngine(cfg, TrainConfig(num_steps=2 * spb.k), spb,
                    device="cuda")
    eng.init_state(0)
    batch = make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=0,
                       device="cuda")
    for s in range(spb.k):                       # warm-up cycle
        eng.train_step(batch, s)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        for s in range(spb.k, 2 * spb.k):
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            torch.cuda.reset_peak_memory_stats()
            with prof:
                t0 = time.perf_counter()
                eng.train_step(batch, s)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            path = os.path.join(tmp, f"step{s}.json")
            prof.export_chrome_trace(path)
            kernels = trace_kernels(path)
            if not kernels:
                raise RuntimeError("the trace holds no kernel events")
            by_class, other = defaultdict(float), defaultdict(float)
            for name, _, dur in kernels:
                by_class[kernel_class(name)] += dur
                if kernel_class(name) == "other":
                    other[name[:60]] += dur
            busy = busy_us(kernels)
            top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
            print(json.dumps({
                "arch": arch, "num_layers": cfg.num_layers,
                "depth": eng.last_depth, "step_ms": wall_us / 1e3,
                "device_busy_ms": busy / 1e3,
                "idle_share": 1.0 - busy / wall_us,
                "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "kernel_ms": {k: v / 1e3 for k, v in sorted(by_class.items())},
                "kernels": len(kernels),
                "top_other_ms": {k: v / 1e3 for k, v in top}}), flush=True)


def main() -> None:
    for arch in ARCHS:
        profile(arch)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
