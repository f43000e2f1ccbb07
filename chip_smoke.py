#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (seconds), print
     the registers and spills (``nvcc -Xptxas -v``) of each kernel of the
     flash forward, delta, dq, dkv, SSD forward, SSD backward and RG-LRU
     libraries and count the tensor-core instructions (HGMMA, HMMA) that
     ``cuobjdump -sass`` finds in each but the delta and RG-LRU ones: none
     fails;
  3. each attention kernel against its plain PyTorch version on the same
     inputs: at the yi-6b main-path shape (B 2, S 2048, H 32, K 4, D 128,
     causal, bf16), a sliding-window case and a ragged Sq != Sk case, at
     the recurrentgemma-2b main-path shape (B 2, S 2048, H 10, K 1,
     D 256, window 2048, bf16) and a case where that window bites
     (S 4096), then the backward kernels on the forward kernel's own
     outputs against the plain chain, and two dq calls and two dkv calls
     bitwise equal; max errors against the stated tolerance, and the
     kernel's (CUDA events over 5 calls, and its kernels' device time
     from ``torch.profiler`` over 20), the plain version's and a library
     call's time at both main-path shapes;
  3b. the same for the SSD kernels: at the mamba2-2.7b main-path shape
     (B 2, S 2048, H 80, P 64, N 128, chunk 256, bf16 x/B/C with B and C
     broadcast over heads, f32 dA), f32 reduced and ragged cases and bf16
     ragged and reduced-width cases, then the backward kernel on the
     forward-with-residuals kernel's own chunk states against the plain
     chain, two calls of each kernel bitwise equal, and the chunk-parallel
     kernels of the two forwards (three each) and of the backward (four)
     timed apart (``torch.profiler``);
  3c. the same for the RG-LRU kernels: at the recurrentgemma-2b main-path
     shape (B 2, S 2048, W 2560, f32), a ragged one (S 600, W 64), S and W
     off the (128-step, 32-channel) tile, and a grid of tiles far larger
     than the card holds at once (B 64, S 8192: the chained scan's forward
     progress), then the backward kernel on the forward kernel's own
     output, and two calls of each kernel bitwise equal;
  4. card against CPU: yi-6b-reduced, mamba2-reduced and then
     recurrentgemma-reduced in f32 with the kernels, 4 temporal SPB steps
     from the same seeded weights as on the CPU plain path, with the card
     run's launch counts checked against the steps' depths;
  5. each path at full width: SPBEngine on yi-6b cut to 8 layers, on
     mamba2-2.7b cut to 32 and on recurrentgemma-2b cut to 12, bf16,
     temporal k=4, batch 2 x 2048, 8 steps, with the launch counts of
     every kernel checked against the step's depth (the counts are zeroed
     before each path and read after it);
  6. temporal-mb at full width: the same three paths, batch 8 x 2048 (four
     microbatches of phase 5's shape, one at each depth of the k=4 cycle,
     then one optimizer step), 3 steps, each step's launches checked
     against its cycle, its time on the host clock and by CUDA events
     beside the sum of one cycle of phase 5's temporal steps; the engine's
     policy sets ``needs_step_time`` and must observe no less than the
     card's time;
  7. card against CPU with gradient compression: the three reduced
     configs, 4 temporal-mb steps with topk and 4 temporal steps with
     lowrank, losses within 1e-3; randk's structure on the card;
  8. the driver's restart loop on the card: yi-6b-reduced with the
     kernels, 8 steps straight and with a failure injected at step 5,
     exactly one FAILURE line and the same last xent to 1e-5;
  9. a JigSaw session at full width: ``LiveBackend`` on the card with a
     yi-6b job (8 layers) and a mamba2-2.7b job (32), two workers each
     (depths 4 and 8, 16 and 32), 3 iterations on 2 machine slots under
     ``JigsawScheduler``, batch 2 x 2048: both jobs done, each task's
     launches checked against its depth (the counts are zeroed before the
     session and read after it), every measured task the interval the
     runtime scheduled, each warm depth's measured ms within 10% of a
     CUDA-event timing of one step at that depth, each worker's estimate
     the EMA of its warm measurements, finite xent; one line a task, the
     host time outside the steps and each job's peak memory;
  10. a fault session on the card: yi-6b-reduced and mamba2-reduced with
     the kernels under one machine crash and one transient task failure,
     checkpointed every iteration: both jobs done, a restore, exactly one
     retry; then a ``KernelError`` raised inside one attempt leaves
     ``ClusterRuntime.run()`` with no retry counted;
  11. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

Needs a CUDA card: without one it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# (atol, rtol) by the kernel output's dtype: a bf16 output against the f32
# plain version is off by bf16 rounding (2^-8 relative) plus the f32 sums'
# order; an f32 output (lse, delta, every output of f32 inputs) is f32 math
# summed in another order.
TOL = {"bfloat16": (5e-3, 2e-2), "float32": (1e-4, 1e-4)}
MAIN = dict(B=2, Sq=2048, Sk=2048, H=32, K=4, D=128, causal=True, window=0,
            dtype="bfloat16")
# recurrentgemma-2b's local attention: MQA, head_dim 256, window 2048
# (which masks nothing more than causality at S 2048)
RG_MAIN = dict(B=2, Sq=2048, Sk=2048, H=10, K=1, D=256, causal=True,
               window=2048, dtype="bfloat16")
CASES = {
    "main": MAIN,
    "window": dict(B=1, Sq=1024, Sk=1024, H=8, K=2, D=64, causal=True,
                   window=256, dtype="float32"),
    "ragged": dict(B=1, Sq=100, Sk=200, H=4, K=2, D=32, causal=False,
                   window=0, dtype="float32"),
    "rg_main": RG_MAIN,
    "rg_window": dict(RG_MAIN, B=1, Sq=4096, Sk=4096),
}
TIMED = {"main": "yi-6b", "rg_main": "recurrentgemma-2b"}   # case: arch
# SSD cases: (B, S, H, P, N, chunk, dtype of x/B/C, B/C broadcast over
# heads); dA is f32 -U(0.05, 2.0) as in tests/test_kernel_grads.py.  Every
# SSD and RG-LRU output is f32, held at that suite's measure:
# max|got - want| / max(max|want|, 1) <= 1e-5.
SCAN_TOL = 1e-5
SSD_MAIN = dict(B=2, S=2048, H=80, P=64, N=128, chunk=256, dtype="bfloat16",
                grouped=True)
SSD_CASES = {
    "main": SSD_MAIN,
    "reduced": dict(B=2, S=256, H=8, P=16, N=16, chunk=32, dtype="float32",
                    grouped=False),
    "ragged": dict(B=1, S=600, H=4, P=64, N=128, chunk=256, dtype="float32",
                   grouped=True),
    "short": dict(B=2, S=100, H=4, P=16, N=16, chunk=256, dtype="float32",
                  grouped=False),
    "bf16_ragged": dict(B=1, S=600, H=4, P=64, N=128, chunk=256,
                        dtype="bfloat16", grouped=True),
    "bf16_reduced": dict(B=2, S=100, H=8, P=16, N=16, chunk=32,
                         dtype="bfloat16", grouped=False),
}
# RG-LRU cases (B, S, W); a ~ U(0.1, 0.999), b ~ N(0, 1) as in
# tests/test_kernel_grads.py.  The kernels' tile is 128 steps by 32
# channels: "off_tile" and "short" miss it in S and W, and "many_tiles"
# hands out 65536 tiles, far more than the card holds at once.
RGLRU_CASES = {
    "main": dict(B=2, S=2048, W=2560),
    "ragged": dict(B=2, S=600, W=64),
    "off_tile": dict(B=3, S=1000, W=100),
    "short": dict(B=1, S=17, W=130),
    "many_tiles": dict(B=64, S=8192, W=512),
}
ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b")
KERNELS = {     # name: (source, TPU kernel it replaces)
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:58"),
    "flash_delta": ("src/repro_torch/csrc/flash_delta.cu",
                    "src/repro/kernels/flash_attention_bwd.py:71"),
    "flash_dq": ("src/repro_torch/csrc/flash_dq.cu",
                 "src/repro/kernels/flash_attention_bwd.py:99"),
    "flash_dkv": ("src/repro_torch/csrc/flash_dkv.cu",
                  "src/repro/kernels/flash_attention_bwd.py:140"),
    "ssd_fwd": ("src/repro_torch/csrc/ssd_fwd.cu",
                "src/repro/kernels/ssd.py:21"),
    "ssd_fwd_res": ("src/repro_torch/csrc/ssd_fwd.cu",
                    "src/repro/kernels/ssd_bwd.py:48"),
    "ssd_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd_bwd.py:129"),
    "rglru_fwd": ("src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru.py:24"),
    "rglru_bwd": ("src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru_bwd.py:27"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
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


def bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_close(name: str, got, want):
    """(max abs error, max abs error over max |want|, tolerance, largest
    share of the allowed error used); raises when
    |got - want| > atol + rtol * |want| with the tolerance of got's dtype."""
    import torch
    atol, rtol = tol = TOL[str(got.dtype).removeprefix("torch.")]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    allowed = atol + rtol * want.abs()
    bad = err > allowed
    max_abs = float(err.max())
    rel = max_abs / max(float(want.abs().max()), 1e-30)
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max_abs_err={max_abs:.3e} exceeds "
                             f"atol {atol} + rtol {rtol} * |want| "
                             f"({int(bad.sum())} elements)")
    return max_abs, rel, tol, float((err / allowed).max())


def check_all(name: str, got, want) -> float:
    """check_close over matching outputs; logs one line, returns the max
    abs error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [check_close(name, g, w) for g, w in zip(got, want, strict=True)]
    max_abs = max(e[0] for e in errs)
    tols = " ".join(f"{a}+{r}*|want|" for a, r in dict.fromkeys(
        e[2] for e in errs))
    each = ",".join(f"{e[0]:.3e}" for e in errs)
    log(f"[kernels] {name:24s} max_abs_err={max_abs:.3e} "
        f"max_rel_err={max(e[1] for e in errs):.3e} per_output=[{each}] "
        f"tol={tols} used={max(e[3] for e in errs):.3f} of it, ok")
    return max_abs


def _kernel_label(mangled: str) -> str:
    """``fwd_wgmma_kernel<128>`` from a mangled ``flash::``, ``ssd::`` or
    ``rglru::`` kernel name."""
    m = re.match(r"_ZN(?:5flash|3ssd|5rglru)(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    rest = mangled[m.end() + int(m.group(1)):]
    args = re.match(r"I((?:f|13__nv_bfloat16|Li\d+E)+)E", rest)
    if not args:
        return name
    label = ["float" if f else "bf16" if bf else d for f, bf, d in
             re.findall(r"(f)|(13__nv_bfloat16)|Li(\d+)E", args.group(1))]
    return f"{name}<{','.join(label)}>"


TENSOR_CORE_LIBS = ("flash_fwd", "flash_dq", "flash_dkv", "ssd_fwd",
                    "ssd_bwd")


def log_resources(lib: str) -> None:
    """Each kernel's registers and spills from the library's build log."""
    from repro_torch.kernels import _build
    fn = None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            fn, spills = _kernel_label(m.group(1)), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            log(f"[build] {lib:9s} {fn:30s} {m.group(1)} registers, "
                f"{spills}")


def phase_tensor_cores() -> dict:
    """Phase 2's report: every kernel's registers and spills, and the
    number of tensor-core instructions in the SASS of each library whose
    bf16 kernels run on the tensor cores.  Raises when one of those has
    none.  Returns {library: {"HGMMA": n, "HMMA": n}}."""
    from repro_torch.kernels import _build
    counts = {}
    log_resources("rglru")
    log_resources("flash_delta")
    for lib in TENSOR_CORE_LIBS:
        log_resources(lib)
        sass = subprocess.run(
            [_build.nvcc_tool("cuobjdump"), "-sass",
             str(_build.lib_path(lib))], check=True, capture_output=True,
            text=True).stdout
        counts[lib] = {op: len(re.findall(rf"\b{op}\b", sass))
                       for op in ("HGMMA", "HMMA")}
        log(f"[build] {lib} tensor-core instructions in SASS: "
            f"{counts[lib]}")
        if not sum(counts[lib].values()):
            raise AssertionError(f"{lib}: no tensor-core instruction in "
                                 f"its SASS")
    return counts


def counters():
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


def zero_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def launches_now() -> dict:
    return {n: fn.launches for n, fn in counters().items()}


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launches_now().items()}


def expected_launches(cfg, depths) -> dict:
    """Launches of ``len(depths)`` steps at these SPB depths, layer by
    layer: an attention layer runs the flash forward always and the delta,
    dq and dkv kernels when it is in the suffix; an SSD layer runs the
    primal scan in the frozen prefix and the forward-with-residuals plus
    the backward in the suffix; an RG-LRU layer runs the scan always and
    the backward scan when it is in the suffix."""
    from repro_torch.config import layer_kinds
    want = dict.fromkeys(counters(), 0)
    kinds = layer_kinds(cfg)
    for d in depths:
        for i, (mixer, _) in enumerate(kinds):
            live = i >= len(kinds) - d
            if mixer == "ssd":
                names = ("ssd_fwd_res", "ssd_bwd") if live else ("ssd_fwd",)
            elif mixer == "rglru":
                names = ("rglru_fwd", "rglru_bwd") if live else ("rglru_fwd",)
            elif mixer in ("attn", "local"):
                names = ("flash_fwd",) + (("flash_delta", "flash_dq",
                                           "flash_dkv") if live else ())
            else:
                raise ValueError(f"no kernels known for mixer {mixer!r}")
            for n in names:
                want[n] += 1
    return want


def check_launches(phase: str, before: dict, depths, cfg) -> dict:
    """The launches since ``before`` against :func:`expected_launches`.
    Returns them."""
    grew = launches_since(before)
    want = expected_launches(cfg, depths)
    if grew != want:
        raise AssertionError(f"{phase}: launches {grew} != {want}")
    return grew


def sms() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def dkv_by_split(bwd, kw, G: int) -> dict:
    """compute_dkv's time with its q heads split over each divisor of G,
    the planner (``dkv_head_splits``) replaced for the measurement."""
    from repro_torch.kernels import flash_attention_bwd as fab
    planner, out = fab.dkv_head_splits, {}
    try:
        for s in (d for d in range(1, G + 1) if G % d == 0):
            fab.dkv_head_splits = lambda *_, s=s: s
            out[s] = round(time_ms(lambda: fab.compute_dkv(*bwd, **kw),
                                   iters=5), 4)
    finally:
        fab.dkv_head_splits = planner
    return out


def phase_kernels():
    """Phase 3: every attention kernel against its plain version; timings
    at each main-path shape.  Returns {case: {name: record}} for the
    timed cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    timed = {}
    for case, c in CASES.items():
        dt = getattr(torch, c["dtype"])
        gen = torch.Generator(device="cuda").manual_seed(1)
        B, Sq, Sk, H, K, D = (c[k] for k in ("B", "Sq", "Sk", "H", "K", "D"))
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
        # public (B, S, H, D) tensors, passed as kernel-layout views
        q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, K, D), mk(B, Sk, K, D), \
            mk(B, Sq, H, D)
        qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
        kw = dict(causal=c["causal"], window=c["window"])
        ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
        delta_p = fab.delta_plain(ot_p, dot_)

        bwd = (qt, kt, vt, dot_, lse_p, delta_p)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "flash_fwd": (
                lambda: fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw),
                lambda: fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)),
            "flash_delta": (lambda: fab.compute_delta(ot_p, dot_),
                            lambda: fab.delta_plain(ot_p, dot_)),
            "flash_dq": (lambda: fab.compute_dq(*bwd, **kw),
                         lambda: fab.dq_plain(*bwd, **kw)),
            "flash_dkv": (lambda: fab.compute_dkv(*bwd, **kw),
                          lambda: fab.dkv_plain(*bwd, **kw)),
        }
        records = {}
        for name, (kern, plain) in runs.items():
            max_abs = check_all(f"{case} {name}", kern(), plain())
            if name in ("flash_dq", "flash_dkv"):   # one owner, no atomics
                first, again = kern(), kern()
                first = first if isinstance(first, tuple) else (first,)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{case}: two {name} calls differ")
            if case in TIMED:
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=5),
                                 "device_ms": round(sum(kernel_device_ms(
                                     kern, "flash", iters=20).values()), 4),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1)}
        # the chain the main path runs: the backward kernels on the forward
        # kernel's own ot and lse, against the plain chain
        ot_k, lse_k = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
        dq_k, dk_k, dv_k = fab.bwd_kernel_layout(qt, kt, vt, ot_k, lse_k,
                                                 dot_, **kw)
        check_all(f"{case} fwd->delta->dq,dkv", (dq_k, dk_k, dv_k),
                  (fab.dq_plain(*bwd, **kw), *fab.dkv_plain(*bwd, **kw)))

        if case not in TIMED:
            continue
        # bounds from this run's inputs: each input read once, each output
        # written once; operations over the pairs the mask lets in
        pairs = int(fa.pair_mask(Sq, Sk, c["causal"], c["window"],
                                 "cpu").sum()) * B * H
        prod = 2.0 * D * pairs                        # one S x S x D product
        work = {
            "flash_fwd": (2 * prod, nbytes(q, k, v, ot_k, lse_k)),
            "flash_delta": (2.0 * B * H * Sq * D, nbytes(ot_p, do, delta_p)),
            "flash_dq": (3 * prod, nbytes(q, k, v, do, lse_p, delta_p, dq_k)),
            "flash_dkv": (4 * prod,
                          nbytes(q, k, v, do, lse_p, delta_p, dk_k, dv_k)),
        }
        for name, (flops, nb) in work.items():
            records[name]["bound_ms"], records[name]["bound_by"] = bound(
                flops, nb, c["dtype"])
        # library yardsticks, never called by the port: SDPA forward (its
        # causal mask is the whole mask at these shapes); the row dot
        # product of O and dO (rounded to bf16 at the end, where the kernel
        # keeps f32); SDPA's backward alone (dQ, dK and dV in one call)
        # for dq and dkv; SDPA forward + backward beside the four kernels
        assert c["causal"] and c["window"] in (0, Sq)
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)
        records["flash_fwd"]["library_ms"] = time_ms(sdpa)
        records["flash_delta"]["library_ms"] = time_ms(
            lambda: torch.linalg.vecdot(ot_p, dot_))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
        gs = do.transpose(1, 2)
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), gs, retain_graph=True))
        for name in ("flash_dq", "flash_dkv"):
            records[name]["library_ms"] = sdpa_bwd
        del out

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
            torch.autograd.grad(out, (qg, kg, vg), gs)

        records["_sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
        records["_dkv_ms_by_split"] = dkv_by_split(bwd, kw, H // K)
        for name in runs:
            r = records[name]
            log(f"[kernels] {case:7s} {name:11s} ms={r['ms']:.4f} "
                f"device_ms={r['device_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) library_ms={r['library_ms']:.4f} "
                f"x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"x_bound_device={r['device_ms'] / r['bound_ms']:.2f} "
                f"x_library={r['ms'] / r['library_ms']:.2f}")
        log(f"[kernels] {case:7s} SDPA fwd+bwd ms="
            f"{records['_sdpa_fwd_bwd_ms']:.4f}")
        log(f"[kernels] {case:7s} flash_dkv ms by head split "
            f"{records['_dkv_ms_by_split']} (the planner takes "
            f"{fab.dkv_head_splits(B, K, H // K, Sk, D, sms())})")
        timed[case] = records
    return timed


def ssd_inputs(c: dict):
    """Public-layout SSD operands on the card for one case: x (B,S,H,P),
    dA (B,S,H) f32, b and c (B,S,H,N) (head-stride-0 views when
    ``grouped``, as the main path passes them), dy, dstate; plus the
    tensors b and c are views of."""
    import torch
    dt = getattr(torch, c["dtype"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, H, P, N = (c[k] for k in ("B", "S", "H", "P", "N"))
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = mk(B, S, H, P).to(dt)
    dA = -(torch.rand((B, S, H), generator=gen, device="cuda") * 1.95 + 0.05)
    heads = 1 if c["grouped"] else H
    b_src, c_src = mk(B, S, heads, N).to(dt), mk(B, S, heads, N).to(dt)
    b, cm = b_src.expand(B, S, H, N), c_src.expand(B, S, H, N)
    return x, dA, b, cm, mk(B, S, H, P), mk(B, H, P, N), (b_src, c_src)


def check_rel(name: str, got, want) -> float:
    """The SSD measure over matching f32 outputs; logs one line, returns
    the max abs error."""
    import torch
    errs = []
    for g, w in zip(got, want, strict=True):
        if g.dtype != torch.float32 or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: expected finite float32 outputs")
        err = float((g - w).abs().max())
        errs.append((err, err / max(float(w.abs().max()), 1.0)))
    rel = max(e[1] for e in errs)
    log(f"[kernels] {name:24s} max_abs_err={max(e[0] for e in errs):.3e} "
        f"rel_err={rel:.3e} per_output=[{','.join(f'{e[1]:.2e}' for e in errs)}]"
        f" tol={SCAN_TOL} {'ok' if rel <= SCAN_TOL else 'FAIL'}")
    if not rel <= SCAN_TOL:
        raise AssertionError(f"{name}: rel_err {rel:.3e} > {SCAN_TOL}")
    return max(e[0] for e in errs)


def kernel_device_ms(kern, namespace: str = "ssd", iters: int = 5) -> dict:
    """The device ms of each CUDA kernel of ``namespace`` that one call of
    a wrapper launches (the bf16 SSD path's chunk-parallel phases; an
    RG-LRU kernel without its scratch's zeroing; an attention kernel
    without the wrapper's host work), averaged over ``iters`` calls traced
    with ``torch.profiler``."""
    import torch
    kern()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kern()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(rf"{namespace}::(\w+)", ev.key)
        if m and ev.device_time_total > 0:
            out[m.group(1)] = round(ev.device_time_total / iters / 1e3, 4)
    if not out:
        raise AssertionError(f"the profiler saw no {namespace} kernel on "
                             f"the card")
    return out


def phase_ssd_kernels():
    """Phase 3b: the SSD kernels against their plain versions; timings and
    bounds at the main-path shape.  Returns {name: record}."""
    import torch
    from repro_torch.kernels import ssd, ssd_bwd

    records = {}
    for case, c in SSD_CASES.items():
        x, dA, b, cm, dy, dstate, srcs = ssd_inputs(c)
        Q = c["chunk"]
        _, _, cs_p = ssd_bwd.fwd_res_plain(x, dA, b, cm, chunk=Q)
        bwd = (x, dA, b, cm, cs_p, dy, dstate)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "ssd_fwd": (
                lambda: ssd.ssd_fwd_kernel_layout(x, dA, b, cm, chunk=Q),
                lambda: ssd.ssd_fwd_plain(x, dA, b, cm, chunk=Q)),
            "ssd_fwd_res": (
                lambda: ssd_bwd.fwd_res_kernel_layout(x, dA, b, cm, chunk=Q),
                lambda: ssd_bwd.fwd_res_plain(x, dA, b, cm, chunk=Q)),
            "ssd_bwd": (
                lambda: ssd_bwd.bwd_kernel_layout(*bwd, chunk=Q),
                lambda: ssd_bwd.bwd_plain(*bwd, chunk=Q)),
        }
        for name, (kern, plain) in runs.items():
            max_abs = check_rel(f"{case} {name}", kern(), plain())
            if case == "main":
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=5),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1),
                                 "library_ms": None}
        # one owner per output, fixed-order sums: two calls agree
        for name, (kern, _) in runs.items():
            first, again = kern(), kern()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{case}: two {name} calls differ")
        log(f"[kernels] {case:24s} two calls of each of {list(runs)} "
            f"bitwise equal")
        if case == "main":
            for name, (kern, _) in runs.items():
                records[f"_{name}_phase_ms"] = kernel_device_ms(kern)
                records[name]["device_ms"] = round(
                    sum(records[f"_{name}_phase_ms"].values()), 4)
                log(f"[kernels] main   {name} by phase (ms): "
                    f"{records[f'_{name}_phase_ms']}")
        # the chain the main path runs: the backward kernel on the forward
        # kernel's own chunk states, against the plain chain
        y_k, st_k, cs_k = ssd_bwd.fwd_res_kernel_layout(x, dA, b, cm, chunk=Q)
        check_rel(f"{case} fwd_res->bwd",
                  ssd_bwd.bwd_kernel_layout(x, dA, b, cm, cs_k, dy, dstate,
                                            chunk=Q),
                  ssd_bwd.bwd_plain(*bwd, chunk=Q))
        if case != "main":
            continue
        # bounds from this run's inputs: each input read once (B and C as
        # the one group they broadcast), each output written once;
        # operations over the causal pairs of each chunk
        B, S, H, P, N = (c[k] for k in ("B", "S", "H", "P", "N"))
        nc = -(-S // Q)
        pairs = Q * (Q + 1) // 2 * nc * B * H
        qpn = 2.0 * Q * P * N * nc * B * H          # one Q x P x N product
        ins = nbytes(x, dA, *srcs)
        grads = ssd_bwd.bwd_kernel_layout(*bwd, chunk=Q)
        work = {
            "ssd_fwd": (2.0 * pairs * (N + P) + 2 * qpn,
                        ins + nbytes(y_k, st_k)),
            "ssd_fwd_res": (2.0 * pairs * (N + P) + 2 * qpn,
                            ins + nbytes(y_k, st_k, cs_k)),
            "ssd_bwd": (2.0 * pairs * (3 * N + 2 * P) + 4 * qpn,
                        ins + nbytes(cs_k, dy, dstate, *grads)),
        }
        for name, (flops, nb) in work.items():
            records[name]["bound_ms"], records[name]["bound_by"] = bound(
                flops, nb, c["dtype"])
            r = records[name]
            log(f"[kernels] main   {name:11s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"library_ms=None (no single PyTorch call computes the "
                f"chunked scan)")
    return records


def phase_rglru_kernels():
    """Phase 3c: the RG-LRU kernels against their plain versions; timings
    and bounds at the main-path shape.  Returns {name: record}."""
    import torch
    from repro_torch.kernels import rglru, rglru_bwd

    records = {}
    for case, c in RGLRU_CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(3)
        shape = (c["B"], c["S"], c["W"])
        a = torch.rand(shape, generator=gen, device="cuda") * 0.899 + 0.1
        b, dy = (torch.randn(shape, generator=gen, device="cuda")
                 for _ in "bd")
        h_p = rglru.rglru_plain(a, b)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "rglru_fwd": (lambda: (rglru.rglru_scan(a, b),),
                          lambda: (rglru.rglru_plain(a, b),)),
            "rglru_bwd": (lambda: rglru_bwd.bwd_kernel_layout(a, h_p, dy),
                          lambda: rglru_bwd.bwd_plain(a, h_p, dy)),
        }
        for name, (kern, plain) in runs.items():
            max_abs = check_rel(f"{case} {name}", kern(), plain())
            if case == "main":
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=20),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1),
                                 "library_ms": None}
            elif case == "many_tiles":
                records[f"_{name}_many_tiles_ms"] = time_ms(kern, iters=3)
        # each tile combines with its one predecessor in a fixed order:
        # two calls agree
        for name, (kern, _) in runs.items():
            first, again = kern(), kern()
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"{case}: two {name} calls differ")
        log(f"[kernels] {case:24s} two calls of each of {list(runs)} "
            f"bitwise equal")
        # the chain the main path runs: the backward kernel on the forward
        # kernel's own output, against the plain chain
        h_k = rglru.rglru_scan(a, b)
        grads = rglru_bwd.bwd_kernel_layout(a, h_k, dy)
        check_rel(f"{case} fwd->bwd", grads, rglru_bwd.bwd_plain(a, h_p, dy))
        if case == "many_tiles":
            log(f"[kernels] many_tiles finished on {sms()} SMs: rglru_fwd "
                f"ms={records['_rglru_fwd_many_tiles_ms']:.4f} rglru_bwd "
                f"ms={records['_rglru_bwd_many_tiles_ms']:.4f}")
        if case != "main":
            continue
        for name, (kern, _) in runs.items():
            records[f"_{name}_device_ms"] = kernel_device_ms(kern, "rglru")
            records[name]["device_ms"] = round(
                sum(records[f"_{name}_device_ms"].values()), 4)
            log(f"[kernels] main   {name} device ms by kernel: "
                f"{records[f'_{name}_device_ms']}")
        # bounds from this run's inputs: each tensor read or written once;
        # one multiply-add per channel and step (two in the backward)
        n = a.numel()
        work = {"rglru_fwd": (2.0 * n, nbytes(a, b, h_k)),
                "rglru_bwd": (4.0 * n, nbytes(a, h_k, dy, *grads))}
        for name, (flops, nb) in work.items():
            records[name]["bound_ms"], records[name]["bound_by"] = bound(
                flops, nb, "float32")
            r = records[name]
            log(f"[kernels] main   {name:11s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"library_ms=None (no single PyTorch call computes a "
                f"linear recurrence)")
    return records


def phase_card_vs_cpu(arch: str):
    """Phase 4: the same 4 SPB steps on the card (kernels) and on the CPU
    (plain versions), from one set of seeded weights."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=4), SPBConfig(mode="temporal", k=4)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    losses = {}
    for dev in ("cuda", "cpu"):
        eng = SPBEngine(cfg, tcfg, spb, device=dev)
        eng.attach_state(steps_lib.state_from_params(
            tree_map(torch.clone, params), tcfg))
        pipe = Pipeline(cfg, 2, 64, seed=0)
        zero_launches()
        before, losses[dev], depths = launches_now(), [], []
        for s in range(4):
            losses[dev].append(float(
                eng.train_step(pipe.get_batch(s), s)["loss"]))
            depths.append(eng.last_depth)
        if dev == "cuda":       # the card run went through the kernels
            grew = check_launches(f"card-vs-cpu {arch}", before, depths, cfg)
            log(f"[card-vs-cpu] {cfg.name} depths={depths} launches="
                f"{ {n: c for n, c in grew.items() if c} }")
    for s, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        rel = abs(a - b) / abs(b)
        log(f"[card-vs-cpu] {cfg.name} step={s} loss_cuda={a:.6f} "
            f"loss_cpu={b:.6f} rel={rel:.2e} tol=1e-3")
        if not rel <= 1e-3:
            raise AssertionError(f"{arch}: card and CPU losses differ at "
                                 f"step {s}")


def phase_full_width(arch: str):
    """Phase 5: one path at full width; returns its launch counts per
    kernel, zeroed just before the run and read just after, and each
    step's ms and depth."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_leaves

    cfg = full_width_config(arch)
    steps = 8
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps),
                    SPBConfig(mode="temporal", k=4), device="cuda")
    t0 = time.perf_counter()
    eng.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(eng.state["params"]))
    log(f"[full-width] {arch} num_layers={cfg.num_layers} {cfg.dtype} "
        f"params={n_params} init_s={time.perf_counter() - t0:.2f}")
    batches = [make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(steps)]
    zero_launches()
    times, depths = [], []
    for s in range(steps):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batches[s], s)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = eng.last_depth
        grew = check_launches(f"full-width {arch} step {s}", before, [d], cfg)
        log(f"[full-width] {arch} step={s} depth={d} loss={loss:.4f} "
            f"gnorm={float(m['grad_norm']):.4f} step_ms={ms:.1f} "
            f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"launches={ {n: c for n, c in grew.items() if c} }")
        if not math.isfinite(loss):
            raise AssertionError(f"{arch}: loss not finite at step {s}")
        times.append(ms)
        depths.append(d)
    return launches_now(), times, depths


class _TimedFullBackprop:
    """A policy that asks for the step's time (``needs_step_time``): the
    engine synchronizes the card before it reads the clock."""
    needs_step_time = True

    def __init__(self):
        self.times = []

    def depth_for_step(self, step):
        return None

    def observe(self, step, step_time_s):
        self.times.append(step_time_s)


def cycle_depths(cfg, spb) -> list:
    """The depths of one temporal-mb step's microbatches, in order."""
    from repro_torch.core import spb as spb_lib
    sched = spb_lib.make_schedule(cfg, spb)
    return [sched.depths[i] for i in sched.order]


def phase_temporal_mb(arch: str, temporal_ms: list) -> dict:
    """Phase 6: temporal-mb at full width, batch 4 x FULL_WIDTH_BATCH x
    FULL_WIDTH_SEQ (each microbatch the shape phase 5's steps run), 3
    steps, each step's launches checked against its cycle's depths.  Its
    policy sets ``needs_step_time``: the time it observes must be no
    shorter than the step's time on the card (CUDA events).  Returns the
    launch counts, zeroed just before the run and read just after."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine

    cfg = full_width_config(arch)
    steps, spb = 3, SPBConfig(mode="temporal-mb", k=4)
    policy = _TimedFullBackprop()
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps), spb, policy=policy,
                    device="cuda")
    eng.init_state(0)
    depths = cycle_depths(cfg, spb)
    batches = [make_batch(cfg, 4 * FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(steps)]
    # the four temporal steps of one cycle in phase 5 (its second cycle)
    four = sum(temporal_ms[len(depths):2 * len(depths)])
    # CUDA events around the step function itself, inside the engine's
    # clock: the card's time from the step's dispatch to its last kernel
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    step_fn = eng.step_fn("mb")

    def timed_step(state, batch):
        ev0.record()
        out = step_fn(state, batch)
        ev1.record()
        return out

    eng._steps["mb"] = timed_step
    zero_launches()
    for s in range(steps):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batches[s], s)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        device_ms = ev0.elapsed_time(ev1)
        observed_ms = policy.times[-1] * 1e3
        grew = check_launches(f"temporal-mb {arch} step {s}", before, depths,
                              cfg)
        log(f"[temporal-mb] {arch} step={s} depths={depths} loss={loss:.4f} "
            f"step_ms={ms:.1f} device_ms={device_ms:.1f} "
            f"observed_ms={observed_ms:.1f} "
            f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"four_temporal_steps_ms={four:.1f} "
            f"launches={ {n: c for n, c in grew.items() if c} }")
        if not math.isfinite(loss):
            raise AssertionError(f"{arch}: temporal-mb loss not finite at "
                                 f"step {s}")
        # CUDA events have ~0.5 us resolution
        if observed_ms < device_ms - 0.01:
            raise AssertionError(
                f"{arch}: a needs_step_time policy observed {observed_ms} ms "
                f"of a step the card ran for {device_ms} ms")
    return launches_now()


def phase_card_vs_cpu_compressed(arch: str):
    """Phase 7: card against CPU with gradient compression: 4 temporal-mb
    steps with topk (batch 4 x 64) and 4 temporal steps with lowrank
    (batch 2 x 64, its projections drawn from the step's CPU generator, so
    both devices project on the same q), from one set of seeded weights,
    losses within 1e-3 relative; then randk's structure on the card."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.core import compress
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    for mode, method, batch in (("temporal-mb", "topk", 4),
                                ("temporal", "lowrank", 2)):
        tcfg = TrainConfig(num_steps=4, compression=method)
        spb = SPBConfig(mode=mode, k=4)
        losses = {}
        for dev in ("cuda", "cpu"):
            eng = SPBEngine(cfg, tcfg, spb, device=dev)
            eng.attach_state(steps_lib.state_from_params(
                tree_map(torch.clone, params), tcfg))
            pipe = Pipeline(cfg, batch, 64, seed=0)
            before, losses[dev], depths = launches_now(), [], []
            for s in range(4):
                losses[dev].append(float(
                    eng.train_step(pipe.get_batch(s), s)["loss"]))
                depths += (cycle_depths(cfg, spb) if mode == "temporal-mb"
                           else [eng.last_depth])
            if dev == "cuda":
                check_launches(f"compressed {mode} {arch}", before, depths,
                               cfg)
        for s, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
            rel = abs(a - b) / abs(b)
            log(f"[compressed] {cfg.name} {mode} {method} step={s} "
                f"loss_cuda={a:.6f} loss_cpu={b:.6f} rel={rel:.2e} "
                f"tol=1e-3")
            if not rel <= 1e-3:
                raise AssertionError(f"{arch} {mode} {method}: card and CPU "
                                     f"losses differ at step {s}")
    # randk draws differ across devices: its structure, leaf by leaf
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).cuda(),
                     params)
    ratio = 0.1
    out = compress.compress_tree(grads, "randk", ratio,
                                 torch.Generator().manual_seed(2))
    for g, c in zip(tree_leaves(grads), tree_leaves(out)):
        kept = c != 0
        if int(kept.sum()) != max(1, int(g.numel() * ratio)) or \
                not torch.equal(c[kept], g[kept] * (1.0 / ratio)):
            raise AssertionError(f"{arch}: randk on the card kept the wrong "
                                 f"entries of a {tuple(g.shape)} leaf")
    log(f"[compressed] {cfg.name} randk on the card: exactly k entries a "
        f"leaf, each g / {ratio}, over {len(tree_leaves(out))} leaves")


def phase_restart() -> None:
    """Phase 8: the driver's restart loop on the card: yi-6b-reduced with
    the kernels, 8 temporal steps with a checkpoint every 4, once straight
    and once with a failure injected at step 5 (restored from step 4):
    exactly one FAILURE line, the injected one, and the same last xent to
    1e-5 relative."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train as train_mod

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--device", "cuda", "--use-pallas", "--arch", "yi-6b",
            "--steps", "8", "--checkpoint-every", "4", "--spb-mode",
            "temporal", "--batch", "2", "--seq", "64", "--log-every", "100"]
    runs = {}
    for name, extra in (("straight", []), ("failed", ["--fail-at", "5"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            history = train_mod.train(args + ["--checkpoint-dir",
                                              str(root / name)] + extra)
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"[restart] {name}: {line}")
        runs[name] = (history, [ln for ln in lines if "FAILURE" in ln])
    shutil.rmtree(root, ignore_errors=True)
    (straight, clean), (failed, failures) = runs["straight"], runs["failed"]
    rel = abs(failed[-1] - straight[-1]) / abs(straight[-1])
    log(f"[restart] last xent straight={straight[-1]:.7f} "
        f"after_restart={failed[-1]:.7f} rel={rel:.2e} tol=1e-5 "
        f"failure_lines={len(failures)}")
    if clean or failures != ["[train] FAILURE: injected failure; restart 1"]:
        raise AssertionError(f"restart: FAILURE lines {clean} / {failures}")
    if not rel <= 1e-5 or len(failed) != 9:
        raise AssertionError("restart: the resumed run does not end where "
                             "the straight one does")


# the JigSaw session (phase 9): per arch, the full-depth step's seconds and
# peak GB at batch 2 x 2048 (PERF.md section 5), seeding the scheduler's
# estimates; the live feedback replaces the times with measurements
JIGSAW_JOBS = {"yi-6b": (0.217, 38.5), "mamba2-2.7b": (0.465, 43.3)}
JIGSAW_TOL = 0.10       # measured step against CUDA events, relative
# the least room (GB) the session's peak allocation must leave on the card:
# the resting tenant's state stays resident while the other steps, so a
# deeper step or a larger state shows here before it runs out of memory
JIGSAW_HEADROOM_GB = 8.0


def _task_log_backend(feed_random: bool):
    """A ``LiveBackend`` that logs each task's (job, worker, iteration,
    depth, measured s, launches, peak allocated and reserved bytes).
    With ``feed_random`` its batches come from ``configs.make_batch`` on
    the card: the ``MarkovLM`` pipeline would build a (vocab, vocab)
    float64 table of ~33 GB at yi-6b's vocabulary."""
    import torch
    from repro_torch.cluster.live import LiveBackend
    from repro_torch.configs import make_batch

    class TaskLogBackend(LiveBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.task_log, self.arrival_s = [], {}

        def job_arrived(self, job, now):
            t0 = time.perf_counter()
            super().job_arrived(job, now)
            torch.cuda.synchronize()
            self.arrival_s[job.job_id] = time.perf_counter() - t0

        def run_task(self, job, task, *a, **kw):
            before = launches_now()
            torch.cuda.reset_peak_memory_stats()
            measured = super().run_task(job, task, *a, **kw)
            self.task_log.append(dict(
                job=task.job_id, worker=task.worker_id, it=task.iteration,
                depth=self.engines[task.job_id].last_depth, s=measured,
                launches=launches_since(before),
                alloc=torch.cuda.max_memory_allocated(),
                reserved=torch.cuda.max_memory_reserved()))
            return measured

        def _stacked_batch(self, jid, step):
            if not feed_random:
                return super()._stacked_batch(jid, step)
            lj = self.jobs[jid]
            return make_batch(lj.cfg, lj.batch, lj.seq, seed=1000 * jid + step,
                              device=self.device)

    return TaskLogBackend


def check_task_launches(phase: str, backend) -> dict:
    """Each logged task's launches against its depth; returns their sum
    by job id."""
    by_job = {}
    for t in backend.task_log:
        want = expected_launches(backend.jobs[t["job"]].cfg, [t["depth"]])
        if t["launches"] != want:
            raise AssertionError(f"{phase}: task {t} launched "
                                 f"{t['launches']} != {want}")
        acc = by_job.setdefault(t["job"], dict.fromkeys(want, 0))
        for n, c in want.items():
            acc[n] += c
    return by_job


def phase_jigsaw(phase5: dict) -> dict:
    """Phase 9: the JigSaw session at full width (see the module
    docstring).  ``phase5``: {arch: (step ms, depths)} of phase 5, printed
    beside the session's warm ms at the same depth.  Returns the launch
    counts by arch, zeroed just before the session and read just after."""
    import torch
    from repro_torch.cluster import ClusterRuntime, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.jigsaw.schedulers import JigsawScheduler

    iters, workers, ema = 3, 2, 0.5
    jobs = []
    for jid, (arch, (est_s, mem_gb)) in enumerate(JIGSAW_JOBS.items()):
        cfg = full_width_config(arch)
        jobs.append(make_live_job(
            jid, arrival=0.0, cfg=cfg, iterations=iters, num_workers=workers,
            batch=FULL_WIDTH_BATCH, seq=FULL_WIDTH_SEQ, est_step_s=est_s,
            est_mem_gb=mem_gb, model_size_gb=0.01,
            tcfg=TrainConfig(num_steps=iters * workers, seed=jid),
            spb=SPBConfig(mode="temporal", k=workers)))
    estimates = {(lj.spec.job_id, w): ws.duration
                 for lj in jobs for w, ws in enumerate(lj.spec.workers)}
    backend = _task_log_backend(feed_random=True)(jobs, device="cuda",
                                                  ema=ema)
    runtime = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                             num_machines=2, machine_mem_gb=80.0, gamma=0.1,
                             horizon=60.0, record_schedule=True)
    zero_launches()
    t0 = time.perf_counter()
    try:
        res = runtime.run()
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(
            f"jigsaw: out of memory after {len(backend.task_log)} tasks "
            f"(peaks so far "
            f"{[round(t['alloc'] / 1e9, 2) for t in backend.task_log]} GB)"
            f": the two tenants no longer fit the card; cut a depth in "
            f"configs.full_width_config") from e
    wall = time.perf_counter() - t0
    grew = launches_now()
    by_job = check_task_launches("jigsaw", backend)
    want = dict.fromkeys(grew, 0)
    for acc in by_job.values():
        for n, c in acc.items():
            want[n] += c
    if grew != want:
        raise AssertionError(f"jigsaw: launches {grew} != {want}")

    names = dict(enumerate(JIGSAW_JOBS))
    for t in backend.task_log:
        log(f"[jigsaw] job={t['job']} ({names[t['job']]}) worker={t['worker']}"
            f" iter={t['it']} depth={t['depth']} measured_ms="
            f"{t['s'] * 1e3:.1f} max_mem_gb={t['alloc'] / 1e9:.2f} "
            f"reserved_gb={t['reserved'] / 1e9:.2f} launches="
            f"{ {n: c for n, c in t['launches'].items() if c} }")
    depths = {j: sorted(d) for j, d in backend.observed_depths.items()}
    log(f"[jigsaw] scheduler=jigsaw jobs_done={len(res.jct)}/{len(jobs)} "
        f"depths={depths} makespan={res.makespan:.3f}s util={res.util:.3f} "
        f"goodput={res.goodput:.3f} migrations={sum(res.migrations.values())}"
        f" wall={wall:.3f}s")
    if len(res.jct) != len(jobs) or res.failed_jobs:
        raise AssertionError(f"jigsaw: jobs_done {len(res.jct)}/{len(jobs)}")
    for lj in jobs:
        jid, L = lj.spec.job_id, lj.cfg.num_layers
        if depths[jid] != [L // workers, L]:
            raise AssertionError(f"jigsaw: job {jid} ran depths "
                                 f"{depths[jid]}, not {[L // workers, L]}")
        if not math.isfinite(backend.last_xent[jid]):
            raise AssertionError(f"jigsaw: job {jid} xent not finite")
    # the virtual clock is the card's: each scheduled interval is the
    # task's measured time
    for m, s, e, jid, wid, it in res.schedule:
        meas = backend.task_measured[(jid, wid, it)]
        if not math.isclose(e - s, meas, rel_tol=1e-9):
            raise AssertionError(f"jigsaw: task {(jid, wid, it)} scheduled "
                                 f"{e - s} s, measured {meas} s")
    # each worker's estimate is the EMA of its warm measurements (its
    # first run, at a depth new to its job, is left out)
    for (jid, w), est in estimates.items():
        want_d = est
        for it in range(1, iters):
            want_d = (1 - ema) * want_d + ema * backend.task_measured[
                (jid, w, it)]
        got = runtime.jobs_by_id[jid].workers[w].duration
        if not math.isclose(got, want_d, rel_tol=1e-12) or got == est:
            raise AssertionError(f"jigsaw: job {jid} worker {w} estimate "
                                 f"{got} != EMA {want_d} (seed {est})")
    spent = sum(backend.task_measured.values())
    arrival = sum(backend.arrival_s.values())
    log(f"[jigsaw] wall_s={wall:.4f} sum_measured_s={spent:.4f} "
        f"job_arrival_s={arrival:.4f} (engine build and init) "
        f"outside_steps_s={wall - spent:.4f} "
        f"outside_steps_less_arrival_s={wall - spent - arrival:.4f} "
        f"share_of_wall_less_arrival="
        f"{(wall - spent - arrival) / (wall - arrival):.4%}")
    for lj in jobs:
        jid = lj.spec.job_id
        mine = [t for t in backend.task_log if t["job"] == jid]
        log(f"[jigsaw] job={jid} ({lj.cfg.name}) peak max_memory_allocated_gb"
            f"={max(t['alloc'] for t in mine) / 1e9:.2f} "
            f"max_memory_reserved_gb="
            f"{max(t['reserved'] for t in mine) / 1e9:.2f} "
            f"final_xent={backend.last_xent[jid]:.4f}")
    free, total = torch.cuda.mem_get_info()
    room = (total - max(t["alloc"] for t in backend.task_log)) / 1e9
    log(f"[jigsaw] card_gb={total / 1e9:.2f} free_gb_now={free / 1e9:.2f} "
        f"room_at_peak_allocation_gb={room:.2f} "
        f"least_room_gb={JIGSAW_HEADROOM_GB}")
    if room < JIGSAW_HEADROOM_GB:
        raise AssertionError(
            f"jigsaw: the peak allocation leaves {room:.2f} GB of the card, "
            f"under {JIGSAW_HEADROOM_GB}: the two tenants are close to not "
            f"fitting; cut a depth in configs.full_width_config")

    # each warm depth's measured ms against CUDA events around one more
    # step of the same engine at that depth
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    for lj in jobs:
        jid, arch = lj.spec.job_id, names[lj.spec.job_id]
        engine = backend.engines[jid]
        p5_ms, p5_depths = phase5[arch]
        for w in range(workers):
            warm = [t["s"] * 1e3 for t in backend.task_log
                    if (t["job"], t["worker"]) == (jid, w) and t["it"] > 0]
            depth = engine.resolve_depth(
                math.ceil((w + 1) / workers * lj.cfg.num_layers))
            batch = make_batch(lj.cfg, lj.batch, lj.seq, seed=999,
                               device="cuda")
            torch.cuda.synchronize()
            ev0.record()
            engine.train_step(batch, depth=depth)
            ev1.record()
            torch.cuda.synchronize()
            event_ms = ev0.elapsed_time(ev1)
            mean = sum(warm) / len(warm)
            # phase 5's second cycle (steps 4-7) at this depth
            p5 = [ms for ms, d in zip(p5_ms[4:], p5_depths[4:]) if d == depth]
            log(f"[jigsaw] job={jid} ({arch}) depth={depth} warm_measured_ms="
                f"{[round(x, 2) for x in warm]} mean={mean:.2f} "
                f"event_ms={event_ms:.2f} rel={mean / event_ms - 1:+.4f} "
                f"tol={JIGSAW_TOL} phase5_step_ms={[round(x, 1) for x in p5]}")
            if abs(mean / event_ms - 1) > JIGSAW_TOL:
                raise AssertionError(f"jigsaw: job {jid} depth {depth}: "
                                     f"measured {mean} ms against events "
                                     f"{event_ms} ms")
    backend.close()
    return {names[jid]: {n: c for n, c in acc.items() if c}
            for jid, acc in by_job.items()}


class _StepClock:
    """A scripted clock: each (start, end) pair of calls measures one
    virtual second, so the fault plan's crash lands mid-session whatever
    the card's speed."""

    def __init__(self):
        self.t, self.mid = 0.0, False

    def __call__(self):
        if self.mid:
            self.t += 1.0
        self.mid = not self.mid
        return self.t


def phase_cluster_faults() -> None:
    """Phase 10: yi-6b-reduced and mamba2-reduced with the kernels on the
    card, two workers each, 4 iterations on 2 machine slots, under one
    crash of machine 0 (t=3.5, back at 4.5) and one transient failure of
    job 1 worker 0's iteration 1, checkpointed every iteration: both jobs
    done, at least one restore, exactly one retry, each task's launches
    against its depth.  Then a ``KernelError`` raised in one attempt
    leaves ``ClusterRuntime.run()`` with no retry counted."""
    import shutil
    from repro_torch.cluster import ClusterRuntime, FaultPlan, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.jigsaw.schedulers import JigsawScheduler
    from repro_torch.kernels._build import KernelError

    def jobs():
        return [make_live_job(
            jid, arrival=0.0,
            cfg=dataclasses.replace(reduced_config(arch), use_pallas=True),
            iterations=4, num_workers=2, batch=2, seq=64, est_step_s=1.0,
            tcfg=TrainConfig(num_steps=8, seed=jid),
            spb=SPBConfig(mode="temporal", k=2))
            for jid, arch in enumerate(JIGSAW_JOBS)]

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cluster"
    shutil.rmtree(root, ignore_errors=True)
    plan = FaultPlan.parse("crash:0@3.5+1.0;fail:1.0@1", restore_s=0.25)
    backend = _task_log_backend(feed_random=False)(
        jobs(), device="cuda", timer=_StepClock(), ckpt_dir=str(root))
    res = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                         num_machines=2, gamma=0.05, horizon=1e9,
                         record_schedule=True, faults=plan,
                         ckpt_every=1).run()
    backend.close()
    shutil.rmtree(root, ignore_errors=True)
    launches = {j: {n: c for n, c in acc.items() if c} for j, acc in
                check_task_launches("cluster-faults", backend).items()}
    log(f"[cluster-faults] jobs_done={len(res.jct)}/2 crashes={res.crashes} "
        f"killed={len(res.killed_tasks)} retried={res.retried_tasks} "
        f"backend_retries={backend.retries} restores={backend.restores} "
        f"lost_iterations={res.lost_iterations} steps_run={backend.steps_run}"
        f" tasks_run={len(backend.task_log)} goodput={res.goodput:.3f} "
        f"util={res.util:.3f} launches={launches}")
    if len(res.jct) != 2 or res.failed_jobs:
        raise AssertionError("cluster-faults: a job did not finish")
    if not sum(backend.restores.values()) or res.crashes != 1:
        raise AssertionError("cluster-faults: the crash restored nothing")
    if res.retried_tasks != [(1, 0, 1)] or backend.retries:
        raise AssertionError("cluster-faults: not exactly one retry")
    if backend.steps_run != {0: 8, 1: 8}:
        raise AssertionError(f"cluster-faults: steps {backend.steps_run}")

    fault = KernelError("injected: flash_dq: CUDA error 700")

    def hook(jid, task, attempt):
        if (jid, task.iteration) == (1, 1):
            raise fault

    naps = []
    backend = _task_log_backend(feed_random=False)(
        jobs(), device="cuda", fault_hook=hook, sleeper=naps.append)
    try:
        ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                       num_machines=2, horizon=1e9).run()
    except KernelError as e:
        if e is not fault:
            raise
    else:
        raise AssertionError("cluster-faults: the KernelError was swallowed")
    backend.close()
    log(f"[cluster-faults] KernelError left run() after "
        f"{len(backend.task_log)} tasks: retries={backend.retries} "
        f"sleeps={naps} failed={backend.failed}")
    if backend.retries or naps or backend.failed:
        raise AssertionError("cluster-faults: a device fault was retried")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[device] {smi}")
    log(f"[device] torch.cuda.get_device_name={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.1f}s "
        f"(phase {time.perf_counter() - t0:.1f}s)")
    tensor_cores = phase_tensor_cores()

    timed = phase_kernels()
    records = dict(timed["main"])
    records.update(phase_ssd_kernels())
    records.update(phase_rglru_kernels())
    torch.cuda.empty_cache()
    for arch in ARCHS:
        phase_card_vs_cpu(arch)
        torch.cuda.empty_cache()
    # each path's own launches: its kernels' counts from its own run
    by_arch, temporal_ms, phase5 = {}, {}, {}
    for arch in ARCHS:
        grew, temporal_ms[arch], depths = phase_full_width(arch)
        phase5[arch] = (temporal_ms[arch], depths)
        by_arch[arch] = {n: c for n, c in grew.items() if c}
        torch.cuda.empty_cache()
    launches = {n: sum(g.get(n, 0) for g in by_arch.values())
                for n in KERNELS}
    idle = [n for n in KERNELS if not launches[n]]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    mb_by_arch = {}
    for arch in ARCHS:
        grew = phase_temporal_mb(arch, temporal_ms[arch])
        mb_by_arch[arch] = {n: c for n, c in grew.items() if c}
        torch.cuda.empty_cache()
    idle = [n for n in KERNELS
            if not any(g.get(n) for g in mb_by_arch.values())]
    if idle:
        raise AssertionError(f"kernels the temporal-mb paths never "
                             f"launched: {idle}")
    for arch in ARCHS:
        phase_card_vs_cpu_compressed(arch)
    phase_restart()
    torch.cuda.empty_cache()
    jigsaw_by_arch = phase_jigsaw(phase5)
    torch.cuda.empty_cache()
    idle = [n for n in KERNELS if not n.startswith("rglru")
            and not any(g.get(n) for g in jigsaw_by_arch.values())]
    if idle:
        raise AssertionError(f"kernels the JigSaw session never launched: "
                             f"{idle}")
    phase_cluster_faults()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "launches_by_arch": {a: g[name] for a, g in by_arch.items()
                                      if name in g},
                 "launches_temporal_mb": {a: g[name]
                                          for a, g in mb_by_arch.items()
                                          if name in g},
                 "launches_jigsaw": {a: g[name]
                                     for a, g in jigsaw_by_arch.items()
                                     if name in g},
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        rg = timed["rg_main"].get(name)
        if rg is not None:      # the flash kernels at recurrentgemma's shape
            entry["at_recurrentgemma_2b"] = rg
        kernels.append(entry)
    log(json.dumps({"kernels": kernels,
                    "sdpa_fwd_bwd_ms": {TIMED[c]: t["_sdpa_fwd_bwd_ms"]
                                        for c, t in timed.items()},
                    "dkv_ms_by_head_split": {
                        TIMED[c]: t["_dkv_ms_by_split"]
                        for c, t in timed.items()},
                    "ssd_phase_ms": {
                        n: records[f"_{n}_phase_ms"]
                        for n in ("ssd_fwd", "ssd_fwd_res", "ssd_bwd")},
                    "rglru_device_ms": {
                        n: records[f"_{n}_device_ms"]
                        for n in ("rglru_fwd", "rglru_bwd")},
                    "rglru_many_tiles_ms": {
                        n: records[f"_{n}_many_tiles_ms"]
                        for n in ("rglru_fwd", "rglru_bwd")},
                    "tensor_core_sass": tensor_cores}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
