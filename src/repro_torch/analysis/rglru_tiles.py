"""Time the RG-LRU chained scan at other tile shapes on one card.

    python -m repro_torch.analysis.rglru_tiles

Builds ``csrc/rglru.cu`` as it is and as each variant of :data:`VARIANTS`
(another value of a tile constant, or launch bounds without their second
argument), each with the flags of ``kernels/_build.py`` into
``build/repro_torch/tiles/``.  At recurrentgemma-2b's shape (B 2, S 2048,
W 2560, f32) it checks each build's ``rglru_fwd`` and ``rglru_bwd``
against the plain versions (SCAN_TOL, 1e-5 of max) and times each with
the chain scratch zeroed for every launch, as the wrappers do, in
rounds that alternate the order of the builds.  Prints the card's name
and power limit, each build's registers and spill stores, and one JSON
line per build with its times in ms.  Needs a card.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels import _build, rglru, rglru_bwd

SHAPE = (2, 2048, 2560)
# name: (text in csrc/rglru.cu, its replacement)
VARIANTS = {
    "steps_32": ("constexpr int L = 16;", "constexpr int L = 32;"),
    "warps_16": ("constexpr int NW = 8;", "constexpr int NW = 16;"),
    "no_min_blocks": ("void __launch_bounds__(NT, 1)",
                      "void __launch_bounds__(NT)"),
}
OUT = _build.BUILD_DIR / "tiles"


def variant_source(name: str) -> str:
    """``csrc/rglru.cu`` with the variant's replacement made; raises when
    its text is not in the source exactly as often as it should be."""
    src = (_build.CSRC / "rglru.cu").read_text()
    if name == "tree":
        return src
    old, new = VARIANTS[name]
    want = 2 if "launch_bounds" in old else 1    # one per kernel
    if src.count(old) != want:
        raise ValueError(f"{name}: {old!r} is in csrc/rglru.cu "
                         f"{src.count(old)} times, not {want}")
    return src.replace(old, new)


def build(names) -> dict:
    """Compile every named build at once; {name: (library, nvcc output)}."""
    built = _build.build_variants({n: variant_source(n) for n in names},
                                  OUT)
    for lib, _ in built.values():
        lib.rglru_scratch_words.argtypes = [ctypes.c_int] * 3
        lib.rglru_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
        lib.rglru_bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
    return built


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def main(rounds: int = 4) -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    names = ["tree", *VARIANTS]
    built = build(names)
    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.rand(SHAPE, generator=gen, device="cuda") * 0.899 + 0.1
    b, dy = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in "bd")
    h_p = rglru.rglru_plain(a, b)
    want = (h_p, *rglru_bwd.bwd_plain(a, h_p, dy))
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, (lib, log) in built.items():
        words = lib.rglru_scratch_words(*SHAPE)

        def fwd(lib=lib, words=words):
            h = torch.empty_like(a)
            scratch = torch.zeros(words, dtype=torch.int32, device="cuda")
            lib.rglru_fwd(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                          scratch.data_ptr(), *SHAPE, stream)
            return h

        def bwd(lib=lib, words=words):
            da, db = torch.empty_like(a), torch.empty_like(a)
            scratch = torch.zeros(words, dtype=torch.int32, device="cuda")
            lib.rglru_bwd(a.data_ptr(), h_p.data_ptr(), dy.data_ptr(),
                          da.data_ptr(), db.data_ptr(), scratch.data_ptr(),
                          *SHAPE, stream)
            return da, db

        got = (fwd(), *bwd())
        err = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1.0)
                  for g, w in zip(got, want))
        if not err <= 1e-5:
            raise AssertionError(f"{name}: rel err {err:.3e} > 1e-5")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[tiles] {name:14s} registers {regs} spill stores {spills} "
              f"rel_err {err:.2e}", flush=True)
        calls[name] = (fwd, bwd)
    times = {name: {"fwd_ms": [], "bwd_ms": []} for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            fwd, bwd = calls[name]
            times[name]["fwd_ms"].append(round(time_ms(fwd), 4))
            times[name]["bwd_ms"].append(round(time_ms(bwd), 4))
    for name in names:
        print(json.dumps({"build": name, **times[name]}), flush=True)


if __name__ == "__main__":
    main()
