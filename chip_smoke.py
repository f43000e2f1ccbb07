#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (seconds);
  3. each kernel against its plain PyTorch version on the same inputs: at
     the main-path shape (B 2, S 2048, H 32, K 4, D 128, causal, bf16), a
     sliding-window case and a ragged Sq != Sk case, then the backward
     kernels on the forward kernel's own outputs against the plain chain;
     max errors against the stated tolerance, and the kernel's, the plain
     version's and a library call's time at the main-path shape;
  4. card against CPU: yi-6b-reduced in f32 with the kernels, 4 temporal
     SPB steps from the same seeded weights as on the CPU plain path, with
     the card run's launch counts checked against the steps' depths;
  5. the slice at full width: SPBEngine on yi-6b cut to 8 layers, bf16,
     temporal k=4, batch 2 x 2048, 8 steps, with the launch counts of
     every kernel checked against the step's depth;
  6. a ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}`` line.

Needs a CUDA card: without one it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
CASES = {
    "main": MAIN,
    "window": dict(B=1, Sq=1024, Sk=1024, H=8, K=2, D=64, causal=True,
                   window=256, dtype="float32"),
    "ragged": dict(B=1, Sq=100, Sk=200, H=4, K=2, D=32, causal=False,
                   window=0, dtype="float32"),
}
KERNELS = {     # name: (source, TPU kernel it replaces)
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:58"),
    "flash_delta": ("src/repro_torch/csrc/flash_delta.cu",
                    "src/repro/kernels/flash_attention_bwd.py:71"),
    "flash_dq": ("src/repro_torch/csrc/flash_dq.cu",
                 "src/repro/kernels/flash_attention_bwd.py:99"),
    "flash_dkv": ("src/repro_torch/csrc/flash_dkv.cu",
                  "src/repro/kernels/flash_attention_bwd.py:140"),
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
    """(max abs error, max abs error over max |want|, tolerance); raises when
    |got - want| > atol + rtol * |want| with the tolerance of got's dtype."""
    import torch
    atol, rtol = tol = TOL[str(got.dtype).removeprefix("torch.")]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_abs = float(err.max())
    rel = max_abs / max(float(want.abs().max()), 1e-30)
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max_abs_err={max_abs:.3e} exceeds "
                             f"atol {atol} + rtol {rtol} * |want| "
                             f"({int(bad.sum())} elements)")
    return max_abs, rel, tol


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
        f"tol={tols} ok")
    return max_abs


def counters():
    """The kernel wrappers, each with its launch count in ``.launches``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    return {"flash_fwd": fa.fwd_kernel_layout,
            "flash_delta": fab.compute_delta,
            "flash_dq": fab.compute_dq, "flash_dkv": fab.compute_dkv}


def zero_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def launches_now() -> dict:
    return {n: fn.launches for n, fn in counters().items()}


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launches_now().items()}


def check_launches(phase: str, before: dict, depths, num_layers: int) -> dict:
    """The launches since ``before`` against ``len(depths)`` steps at these
    depths: the forward in every layer, each backward kernel in the step's
    suffix only.  Returns them."""
    grew = launches_since(before)
    want = {"flash_fwd": len(depths) * num_layers,
            **{n: sum(depths) for n in ("flash_delta", "flash_dq",
                                        "flash_dkv")}}
    if grew != want:
        raise AssertionError(f"{phase}: launches {grew} != {want}")
    return grew


def phase_kernels():
    """Phase 3: every kernel against its plain version; timings at the
    main-path shape.  Returns {name: record} for the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    records = {}
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
        for name, (kern, plain) in runs.items():
            max_abs = check_all(f"{case} {name}", kern(), plain())
            if case == "main":
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=5),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1)}
        # the chain the main path runs: the backward kernels on the forward
        # kernel's own ot and lse, against the plain chain
        ot_k, lse_k = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
        dq_k, dk_k, dv_k = fab.bwd_kernel_layout(qt, kt, vt, ot_k, lse_k,
                                                 dot_, **kw)
        check_all(f"{case} fwd->delta->dq,dkv", (dq_k, dk_k, dv_k),
                  (fab.dq_plain(*bwd, **kw), *fab.dkv_plain(*bwd, **kw)))

        if case != "main":
            continue
        # bounds from this run's inputs: each input read once, each output
        # written once; operations over the pairs the causal mask lets in
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
        # library yardsticks, never called by the port: SDPA forward; the
        # row dot product of O and dO (rounded to bf16 at the end, where the
        # kernel keeps f32); SDPA forward + backward beside the four kernels
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True)
        records["flash_fwd"]["library_ms"] = time_ms(sdpa)
        records["flash_delta"]["library_ms"] = time_ms(
            lambda: torch.linalg.vecdot(ot_p, dot_))
        for name in ("flash_dq", "flash_dkv"):
            records[name]["library_ms"] = None
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
        gs = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                 enable_gqa=True)
            torch.autograd.grad(out, (qg, kg, vg), gs)

        records["_sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
        for name in KERNELS:
            r = records[name]
            log(f"[kernels] main   {name:11s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) library_ms={r['library_ms']}")
        log(f"[kernels] main   SDPA fwd+bwd ms="
            f"{records['_sdpa_fwd_bwd_ms']:.4f}")
    return records


def phase_card_vs_cpu():
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

    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
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
            grew = check_launches("card-vs-cpu", before, depths,
                                  cfg.num_layers)
            log(f"[card-vs-cpu] depths={depths} launches={grew}")
    for s, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        rel = abs(a - b) / abs(b)
        log(f"[card-vs-cpu] step={s} loss_cuda={a:.6f} loss_cpu={b:.6f} "
            f"rel={rel:.2e} tol=1e-3")
        if not rel <= 1e-3:
            raise AssertionError(f"card and CPU losses differ at step {s}")


def phase_full_width():
    """Phase 5: the slice at full width; returns the main path's launch
    counts per kernel."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_leaves

    cfg = full_width_config()
    steps = 8
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps),
                    SPBConfig(mode="temporal", k=4), device="cuda")
    t0 = time.perf_counter()
    eng.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(eng.state["params"]))
    log(f"[full-width] yi-6b num_layers={cfg.num_layers} {cfg.dtype} "
        f"params={n_params} init_s={time.perf_counter() - t0:.2f}")
    batches = [make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(steps)]
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
        d = eng.last_depth
        log(f"[full-width] step={s} depth={d} loss={loss:.4f} "
            f"gnorm={float(m['grad_norm']):.4f} step_ms={ms:.1f} "
            f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"launches={launches_since(before)}")
        if not math.isfinite(loss):
            raise AssertionError(f"loss not finite at step {s}")
        check_launches(f"full-width step {s}", before, [d], cfg.num_layers)
    return launches_now()


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

    records = phase_kernels()
    torch.cuda.empty_cache()
    phase_card_vs_cpu()
    torch.cuda.empty_cache()
    launches = phase_full_width()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels,
                    "sdpa_fwd_bwd_ms": records["_sdpa_fwd_bwd_ms"]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
