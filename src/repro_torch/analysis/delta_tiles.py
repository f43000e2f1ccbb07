"""Time the delta kernel at other block shapes on one card.

    python -m repro_torch.analysis.delta_tiles [--parent PATH] [--rounds N]

Builds ``csrc/flash_delta.cu`` with each pair of threads per block
(``DELTA_NT``) and rows per thread (``DELTA_RPT``) in :data:`GRID`, the
tree's pair among them, and with ``--parent`` another source with the
same C entry (such as an earlier commit's ``flash_delta.cu``), each with
the flags of ``kernels/_build.py`` into ``build/repro_torch/delta_tiles/``.
At yi-6b's and recurrentgemma-2b's main-path shapes (bf16 O and dO as the
main path hands them: transposed views of contiguous (B, S, H, D)) it
checks each build against ``delta_plain`` (atol = rtol = 1e-4) and two
calls for equal bits.  Then, in rounds that alternate the order of the
builds, it times each build and ``torch.linalg.vecdot(O, dO)`` three ways:
the CUDA-event time of 50 back-to-back calls (as ``chip_smoke.py``'s
``time_ms``); the device time of 20 back-to-back calls (``warm``: part of
the inputs may still sit in the 50 MB L2); and the device time of 20
calls, each after a read of a 256 MB buffer (``cold``: the inputs come
from device memory).  Device times are the kernels launched inside a
profiler range (``step_profile.range_device_ms``).  Prints the card's name
and power limit, each build's registers and spill stores, and one JSON
line per build and shape with its times in ms and the bytes bound.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.analysis.roofline import HBM_BW
from repro_torch.analysis.step_profile import range_device_ms
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab

SHAPES = {"yi-6b": (2, 2048, 32, 128),            # (B, S, H, D), bf16
          "recurrentgemma-2b": (2, 2048, 10, 256)}
GRID = tuple((nt, rpt) for nt in (128, 256, 512) for rpt in (1, 2, 4, 8))
OUT = _build.BUILD_DIR / "delta_tiles"


def variant_source(nt: int, rpt: int) -> str:
    """``csrc/flash_delta.cu`` with ``DELTA_NT = nt`` and ``DELTA_RPT =
    rpt``; raises when either constant is not defined there exactly
    once."""
    src = (_build.CSRC / "flash_delta.cu").read_text()
    for name, value in (("DELTA_NT", nt), ("DELTA_RPT", rpt)):
        pattern = rf"constexpr int {name} = \d+;"
        if len(re.findall(pattern, src)) != 1:
            raise ValueError(f"{name} is not defined once in flash_delta.cu")
        src = re.sub(pattern, f"constexpr int {name} = {value};", src)
    return src


def tree_pair() -> tuple:
    """(DELTA_NT, DELTA_RPT) as the tree's source sets them."""
    src = (_build.CSRC / "flash_delta.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("DELTA_NT", "DELTA_RPT"))


def build(sources: dict) -> dict:
    """Compile every {name: source text} at once; {name: (entry, nvcc
    output)}."""
    built = {}
    for name, (lib, log) in _build.build_variants(sources, OUT).items():
        lib.flash_delta.argtypes = fab._DELTA_ARGTYPES
        built[name] = (lib.flash_delta, log)
    return built


def caller(entry, o, do):
    """One call as ``compute_delta`` makes it, through ``entry``."""
    B, H, S, D = o.shape
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        delta = torch.empty((B, H, S), dtype=torch.float32, device=o.device)
        code = entry(1, o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, H,
                     S, D, *fa.strides(o), *fa.strides(do), stream)
        if code:
            raise RuntimeError(f"flash_delta returned {code}")
        return delta
    return call


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, flush: torch.Tensor, iters: int = 20) -> dict:
    """{"warm": ms, "cold": ms}: the device time of the kernels ``fn``
    launches, back to back and each after a read of ``flush``."""
    fn()
    torch.cuda.synchronize()
    rec = torch.profiler.record_function
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            with rec("warm"):
                fn()
        for _ in range(iters):
            flush.sum()
            with rec("cold"):
                fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ms = range_device_ms(events, ("warm", "cold"))
    if not ms["warm"]["fwd"] or not ms["cold"]["fwd"]:
        raise RuntimeError("the trace holds no kernel inside a timed range")
    return {k: round(ms[k]["fwd"] / iters, 5) for k in ("warm", "cold")}


def main(parent: str = None, rounds: int = 3) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    tree = tree_pair()
    sources = {f"nt{nt}_rpt{rpt}": variant_source(nt, rpt)
               for nt, rpt in GRID}
    if parent:
        sources["parent"] = Path(parent).read_text()
    built = build(sources)
    for name, (_, log) in built.items():
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                   log)})
        spills = sorted({int(s) for s in re.findall(
            r"(\d+) bytes spill stores", log)})
        print(f"[delta_tiles] {name:12s} registers {regs} spill stores "
              f"{spills}", flush=True)
    flush = torch.empty(64 * 2 ** 20, device="cuda")     # 256 MB of f32
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls, bounds = {}, {}
    for shape, (B, S, H, D) in SHAPES.items():
        o, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                 .to(torch.bfloat16).transpose(1, 2) for _ in "od")
        want = fab.delta_plain(o, do)
        bounds[shape] = (2 * o.numel() * 2 + want.numel() * 4) / HBM_BW
        calls[shape] = {"vecdot": lambda o=o, do=do: torch.linalg.vecdot(
            o, do)}
        for name, (entry, _) in built.items():
            call = caller(entry, o, do)
            first, again = call(), call()
            torch.testing.assert_close(first, want, atol=1e-4, rtol=1e-4)
            if not torch.equal(first, again):
                raise AssertionError(f"{name} at {shape}: two calls differ")
            calls[shape][name] = call
    print(f"[delta_tiles] every build matches delta_plain and repeats its "
          f"bits at {list(SHAPES)}; the tree's pair is nt{tree[0]}_rpt"
          f"{tree[1]}", flush=True)
    names = list(calls[next(iter(SHAPES))])
    times = {(s, n): {"event_ms": [], "warm_ms": [], "cold_ms": []}
             for s in SHAPES for n in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            for shape in SHAPES:
                fn = calls[shape][name]
                t = times[(shape, name)]
                t["event_ms"].append(round(event_ms(fn), 5))
                dev = device_ms(fn, flush)
                t["warm_ms"].append(dev["warm"])
                t["cold_ms"].append(dev["cold"])
    for (shape, name), t in times.items():
        print(json.dumps({"shape": shape, "build": name,
                          "bound_ms": round(bounds[shape] * 1e3, 5), **t}),
              flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another flash_delta.cu to time")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    main(args.parent, args.rounds)
