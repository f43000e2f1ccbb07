"""Where a full-width SPB step spends the card's time.

    python -m repro_torch.analysis.step_profile [arch ...]

Runs the chip smoke's full-width configurations, or the named ones, one
after the other (``configs.full_width_config``: yi-6b cut to 8 layers,
mamba2-2.7b cut to 32, recurrentgemma-2b cut to 12, gemma3-4b cut to 12,
qwen3-moe-235b-a22b cut to 4 layers of 8 held experts, seamless-m4t-medium
whole (12 + 12 layers) and internvl2-26b cut to 4, bf16, the
hand-written kernels; temporal SPB k=4, batch 2 x 2048).  For each it
warms up one depth cycle, then traces one step at each depth of the next
cycle with ``torch.profiler``.  For each depth it prints the step's host time, the
device's busy time (the union of kernel intervals in the trace), the
idle share, the peak memory, and the kernel time by class: the port's
kernels (four attention, three SSD, two RG-LRU; in bf16 the two SSD
forwards share one class), matrix products, and everything else, with
the largest kernels of the last class.  It also gives the device time of
the kernels each profiler range of the model launched (``RANGES``: the
RG-LRU gates and scan; the MoE routing, expert products and combine; an
encoder-decoder's encoder stack and its decoder's cross-attention), in
the forward and in their backward, with the
matmul class's share.  Needs a card.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from repro_torch.models import layers, lm, moe, ssm

ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b", "gemma3-4b",
         "qwen3-moe-235b-a22b", "seamless-m4t-medium", "internvl2-26b")
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
RANGES = (ssm.GATES_RANGE, ssm.SCAN_RANGE, moe.ROUTE_RANGE,
          moe.EXPERTS_RANGE, moe.COMBINE_RANGE, lm.ENCODER_RANGE,
          layers.CROSS_RANGE)


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if all(k in name for k in keys):
            return cls
    low = name.lower()
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "matmul"
    return "other"


def trace_kernels(events):
    """(name, start_us, dur_us) of every kernel in a chrome trace's
    events."""
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel"]


def range_device_ms(events, names=RANGES) -> dict:
    """{range: {"fwd": ms, "bwd": ms, "fwd_matmul": ms, "bwd_matmul": ms}}:
    the device time of the kernels launched inside each ``record_function``
    range, and of those launched by the autograd nodes of the ops the range
    ran (a node's ``evaluate_function`` event carries its op's sequence
    number); the ``_matmul`` keys take the matmul class alone.  A kernel is
    matched to its launch by the trace's correlation id."""
    spans = {n: [] for n in names}
    launch_at, ops = {}, []
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat == "user_annotation" and e["name"] in spans:
            spans[e["name"]].append(
                (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_at[args["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat == "cpu_op" and "Sequence number" in args:
            ops.append(e)

    def inside(tid, ts, intervals):
        return any(t == tid and lo <= ts <= hi for t, lo, hi in intervals)

    backward = "autograd::engine::evaluate_function"
    parts = {}
    for n, fwd in spans.items():
        seqs = {e["args"]["Sequence number"] for e in ops
                if not e["name"].startswith(backward)
                and inside(e["tid"], float(e["ts"]), fwd)}
        bwd = [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
               for e in ops if e["name"].startswith(backward)
               and e["args"]["Sequence number"] in seqs]
        parts[n] = {"fwd": fwd, "bwd": bwd}
    out = {n: dict.fromkeys(("fwd", "bwd", "fwd_matmul", "bwd_matmul"), 0.0)
           for n in names}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launch_at.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        for n, by_part in parts.items():
            for part, intervals in by_part.items():
                if inside(*launch, intervals):
                    out[n][part] += float(e["dur"]) / 1e3
                    if kernel_class(e["name"]) == "matmul":
                        out[n][f"{part}_matmul"] += float(e["dur"]) / 1e3
    return out


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
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            kernels = trace_kernels(events)
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
                "range_ms": range_device_ms(events),
                "kernels": len(kernels),
                "top_other_ms": {k: v / 1e3 for k, v in top}}), flush=True)


def main(archs=ARCHS) -> None:
    for arch in archs:
        profile(arch)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:] or ARCHS)
