"""Step stalls of ``chip_smoke.py`` in two checkouts: Python's garbage
collections and the caching allocator's device mallocs timed against each
train step.

    python -m repro_torch.analysis.step_stalls A_DIR B_DIR \\
        --order A B B+ B+ B A --out results/step_stalls.json
    python -m repro_torch.analysis.step_stalls A_DIR B_DIR --full \\
        --order A B B A --out results/step_stalls_full.json

Each run is a fresh process that imports ``chip_smoke`` and ``repro_torch``
from one checkout (``A``, ``B``; ``B+`` is ``B`` with one dry-run count on
the meta device made first, which loads the modules a dry run loads),
builds the kernels and runs phase 5 on yi-6b and mamba2-2.7b and then
phase 9 on their steps, as ``chip_smoke.py`` does; with ``--full`` it runs
the whole of ``chip_smoke.main()`` instead.  A ``gc.callbacks`` hook
times every collection, and every ``SPBEngine.train_step`` call records
its host time to return (the enqueue), its span on the stream by CUDA
events, the device segments the allocator mapped and unmapped
(``torch.cuda.memory_stats``: ``segment.all.allocated`` / ``freed``, a
``cudaMalloc`` / ``cudaFree`` each), the bytes it reserved
(``reserved_bytes.all.allocated``: new segments, or an expandable
segment's growth) and its retries, and the
collections that start inside it.  A phase-5 step is matched to the
call that ends last before phase 5 logs it.  Phase 9's failure, if any,
is recorded, not raised.

Prints one line a run and writes the runs as JSON to ``--out`` (each
run's own output beside it, ``<out>.<i>.log``).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ARCHS = ("yi-6b", "mamba2-2.7b")        # phase 9's two tenants


def child(tree: Path, dryrun_first: bool, full: bool, out: Path) -> None:
    """One run, in this process, on the checkout at ``tree``."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import gc
    import importlib

    import torch

    cs = importlib.import_module("chip_smoke")
    assert Path(cs.__file__).resolve().parent == tree.resolve()
    from repro_torch.engine.engine import SPBEngine

    collections, started = [], {}

    def hook(phase, info):
        now = time.perf_counter()
        if phase == "start":
            started["t"] = now
        elif "t" in started:
            t0 = started.pop("t")
            collections.append({"t": t0, "ms": (now - t0) * 1e3,
                                "gen": info["generation"]})

    gc.callbacks.append(hook)
    calls = []
    train_step = SPBEngine.train_step
    stats = {"allocated": "segment.all.allocated",
             "freed": "segment.all.freed",
             "mapped_bytes": "reserved_bytes.all.allocated",
             "num_alloc_retries": "num_alloc_retries"}

    def timed_step(self, *args, **kwargs):
        before = torch.cuda.memory_stats()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        out = train_step(self, *args, **kwargs)
        ev[1].record()
        t1 = time.perf_counter()
        after = torch.cuda.memory_stats()
        calls.append({"arch": self.cfg.name, "layers": self.cfg.num_layers,
                      "device": str(self.device),
                      "depth": self.last_depth, "t0": t0, "t1": t1,
                      "enqueue_ms": (t1 - t0) * 1e3, "ev": ev,
                      **{name: after.get(k, 0) - before.get(k, 0)
                         for name, k in stats.items()}})
        return out

    SPBEngine.train_step = timed_step
    lines = []
    log = cs.log

    def timed_log(msg: str) -> None:
        lines.append((time.perf_counter(), msg))
        log(msg)

    cs.log = timed_log
    rec = {"tree": str(tree), "dryrun_first": dryrun_first, "full": full}
    if full:
        try:
            rec["main"] = f"exit {cs.main()}"
        except Exception as e:      # noqa: BLE001 -- recorded
            rec["main"] = f"raised {e!r}"[:400]
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import _build
        _build.build()
        if dryrun_first:
            from repro_torch.launch import dryrun
            dryrun.count_cell("yi-6b", "train_4k", cut="reduced", depth=2,
                              batch=2, seq_len=64)
        rec["gc_objects_before"] = len(gc.get_objects())
        phase5 = {}
        for arch in ARCHS:
            _, ms, depths, *_ = cs.phase_full_width(arch)
            phase5[arch] = (ms, depths)
            torch.cuda.empty_cache()
        try:
            cs.phase_jigsaw(phase5)
            rec["main"] = "phases 5 and 9 ok"
        except AssertionError as e:
            rec["main"] = f"phase 9 failed: {e}"[:400]
    torch.cuda.synchronize()
    for c in calls:
        ev = c.pop("ev")
        c["span_ms"] = ev[0].elapsed_time(ev[1])
        c["gc"] = [(g["gen"], round(g["ms"], 2)) for g in collections
                   if c["t0"] <= g["t"] <= c["t1"]]
    # a phase-5 step: the call that ends last before its line is logged
    for t, msg in lines:
        m = re.match(r"\[full-width\] (\S+) step=(\d+) depth=(\d+) .* "
                     r"step_ms=([\d.]+)", msg)
        if m:
            mine = [c for c in calls if c["t1"] <= t]
            if mine:
                mine[-1].update(phase5_step=int(m[2]),
                                wall_ms=float(m[4]))
    rec["calls"] = calls
    rec["gc_objects_after"] = len(gc.get_objects())
    rec["gc_max_ms_by_gen"] = {
        g: max([c["ms"] for c in collections if c["gen"] == g] or [0.0])
        for g in range(3)}
    out.write_text(json.dumps(rec))


def stalls(rec: dict, over: float = 1.15) -> list:
    """The calls whose span on the stream is ``over`` times or more the
    median span of the calls of their config, device and depth (each
    group's first call, a cold one, left out)."""
    groups = {}
    for c in rec["calls"]:
        groups.setdefault((c["arch"], c["layers"], c["device"], c["depth"]),
                          []).append(c)
    out = []
    for group in groups.values():
        warm = sorted(c["span_ms"] for c in group[1:])
        if len(warm) < 2:
            continue
        median = warm[len(warm) // 2]
        out += [dict(c, median_ms=median) for c in group[1:]
                if c["span_ms"] >= over * median]
    return out


def summary(label: str, rec: dict) -> str:
    slow = stalls(rec)
    n_warm = len(rec["calls"]) - len(
        {(c["arch"], c["layers"], c["device"], c["depth"])
         for c in rec["calls"]})
    mallocs = sum(c["allocated"] for c in rec["calls"])
    warm = _warm(rec)
    mapping = [c for c in warm if c.get("mapped_bytes", 0) > 0]
    return (f"{label:3s} {rec['main'][:120]} | train steps "
            f"{len(rec['calls'])} ({n_warm} warm), device mallocs in them "
            f"{mallocs}; warm steps that mapped device memory "
            f"{len(mapping)} ({sum(c['mapped_bytes'] for c in mapping) / 1e9:.2f}"
            f" GB, {sum(c['allocated'] for c in warm)} segments), allocator "
            f"retries in warm steps "
            f"{sum(c['num_alloc_retries'] for c in warm)} | warm steps 15% "
            f"over their median: "
            + "; ".join(f"{c['arch']}/{c['layers']} d{c['depth']} span "
                        f"{c['span_ms']:.1f} (median {c['median_ms']:.1f}) "
                        f"enqueue {c['enqueue_ms']:.1f} mallocs "
                        f"{c['allocated']} mapped_mb "
                        f"{c.get('mapped_bytes', 0) / 1e6:.0f} frees "
                        f"{c['freed']} retries "
                        f"{c['num_alloc_retries']} gc {c['gc']}"
                        for c in slow)
            + f" | gc max ms by gen {rec['gc_max_ms_by_gen']}")


def _warm(rec: dict) -> list:
    """The calls after the first of their (config, device, depth)."""
    seen, warm = set(), []
    for c in rec["calls"]:
        key = (c["arch"], c["layers"], c["device"], c["depth"])
        if key in seen:
            warm.append(c)
        seen.add(key)
    return warm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path, help="checkout A (e.g. the parent)")
    ap.add_argument("b", type=Path, help="checkout B (e.g. the change)")
    ap.add_argument("--order", nargs="+", default=["A", "B", "B", "A"],
                    choices=["A", "B", "B+"])
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--full", action="store_true",
                    help="run all of chip_smoke.main(), not phases 5 and 9")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-first", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.dryrun_first, args.full, args.child_out)
        return 0
    runs = []
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for i, label in enumerate(args.order):
        tree = (args.a if label == "A" else args.b).resolve()
        part = args.out.with_suffix(f".{i}.json")
        cmd = [sys.executable, str(Path(__file__).resolve()), str(args.a),
               str(args.b), "--out", str(args.out), "--child", str(tree),
               "--child-out", str(part)]
        if label == "B+":
            cmd.append("--dryrun-first")
        if args.full:
            cmd.append("--full")
        t0 = time.perf_counter()
        with open(part.with_suffix(".log"), "w") as f:
            rc = subprocess.run(cmd, stdout=f).returncode
        if rc:
            print(f"{label}: run {i} exited {rc}", flush=True)
            runs.append({"label": label, "rc": rc})
            continue
        rec = json.loads(part.read_text())
        rec.update(label=label, rc=0, wall_s=time.perf_counter() - t0)
        runs.append(rec)
        print(summary(label, rec), flush=True)
    args.out.write_text(json.dumps(runs, indent=1))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
