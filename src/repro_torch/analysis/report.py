"""Render markdown tables from the dry-run records (the counterpart of
``repro/analysis/report.py``).

  python -m repro_torch.analysis.report roofline    # full-backprop roofline
  python -m repro_torch.analysis.report dryrun      # every record
  python -m repro_torch.analysis.report perf        # tagged variant deltas
  python -m repro_torch.analysis.report spb         # SPB depth sweeps

Each reads ``results/dryrun_torch/`` (or ``results_dir``).  A record is
one cell at one cut of its config (published, ``full_width`` or
``reduced``) and one batch; the tables name both.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from repro_torch.analysis.roofline import (MESH, record_config, records,
                                           roofline_row)

# what moves each (bound, kind) on one H100, for the roofline table
ADVICE = {
    ("memory", "train"): "fewer unfused elementwise passes (AdamW's f32 "
                         "update first), bf16 streams, fused norms",
    ("memory", "prefill"): "fused norms and rope around the flash kernels; "
                           "bf16 streams",
    ("memory", "decode"): "KV-cache and weight reads dominate: wider slot "
                          "batches, a routed MoE layer",
    ("compute", "train"): "near roofline: higher tensor-core occupancy in "
                          "the matmuls and the flash kernels",
    ("compute", "prefill"): "the same: tensor-core occupancy",
}


def _variant(rec: dict) -> str:
    remat = rec.get("remat", "none")
    return (f"{rec.get('cut', 'published')} {rec['batch']}x{rec['seq_len']}"
            + (f" remat-{remat}" if remat != "none" else ""))


def md_roofline(mesh: str = MESH, results_dir: Optional[Path] = None) -> str:
    out = ["| arch | variant | shape | chips | compute (s) | memory (s) | "
           "collective (s) | bound | MFU | useful ratio | what moves the "
           "bound |",
           "|---|---|---|---:|---:|---:|---:|---|---:|---:|---|"]
    for rec in records(results_dir):
        if rec.get("mesh") != mesh or rec.get("depth") is not None:
            continue
        r = roofline_row(rec, record_config(rec))
        out.append(
            f"| {r.arch} | {_variant(rec)} | {r.shape} | {r.chips} | "
            f"{r.compute_s:.4f} | {r.memory_s:.4f} | {r.collective_s:.4f} | "
            f"{r.dominant} | {r.mfu:.1%} | {r.useful_ratio:.2f} | "
            f"{ADVICE.get((r.dominant, rec['kind']), '-')} |")
    return "\n".join(out)


def md_dryrun(results_dir: Optional[Path] = None) -> str:
    out = ["| arch | variant | shape | depth | count (s) | flops/dev | "
           "bytes/dev | wire bytes/dev | #coll | args GiB | temp GiB |",
           "|---|---|---|---:|---:|---:|---:|---:|---:|---:|---:|"]
    for rec in records(results_dir):
        ma = rec.get("memory_analysis", {})
        depth = rec["depth"] if rec["depth"] is not None else "full"
        out.append(
            f"| {rec['arch']} | {_variant(rec)} | {rec['shape']} | {depth} | "
            f"{rec['count_s']:.2f} | {rec['flops_per_device']:.3e} | "
            f"{rec['bytes_per_device']:.3e} | "
            f"{rec['collective_bytes_per_device']:.3e} | "
            f"{rec['num_collectives']} | "
            f"{ma.get('argument_size_in_bytes', 0) / 2**30:.2f} | "
            f"{ma.get('temp_size_in_bytes', 0) / 2**30:.2f} |")
    return "\n".join(out)


def _cell(rec: dict):
    return (rec["arch"], rec["shape"], rec["mesh"], rec.get("cut"),
            rec["batch"], rec["seq_len"], rec.get("remat", "none"),
            rec.get("depth"))


def md_perf(results_dir: Optional[Path] = None) -> str:
    """Variant (tagged) records against their untagged baselines."""
    out = ["| cell | variant | flops/dev | bytes/dev | wire bytes/dev | "
           "temp GiB | Δbytes vs base | Δflops vs base |",
           "|---|---|---:|---:|---:|---:|---:|---:|"]
    recs = records(results_dir)
    base = {_cell(r): r for r in recs if not r.get("tag")}
    for rec in (r for r in recs if r.get("tag")):
        b = base.get(_cell(rec))
        ma = rec.get("memory_analysis", {})
        db = df = "-"
        if b:
            db = f"{100 * (rec['bytes_per_device'] / b['bytes_per_device'] - 1):+.1f}%"
            df = f"{100 * (rec['flops_per_device'] / b['flops_per_device'] - 1):+.1f}%"
        depth = rec["depth"] if rec["depth"] is not None else "full"
        out.append(
            f"| {rec['arch']}/{_variant(rec)}/{rec['shape']}/d{depth} | "
            f"{rec['tag']} | {rec['flops_per_device']:.3e} | "
            f"{rec['bytes_per_device']:.3e} | "
            f"{rec['collective_bytes_per_device']:.3e} | "
            f"{ma.get('temp_size_in_bytes', 0) / 2**30:.1f} | {db} | {df} |")
    return "\n".join(out)


def md_spb(results_dir: Optional[Path] = None) -> str:
    """SPB depth sweeps of the train records (the paper's Table 1, counted):
    each depth against the same cell's full-backprop record."""
    out = ["| arch | variant | depth | flops/dev | bytes/dev | saved GiB | "
           "vs full flops | vs full bytes | vs full saved |",
           "|---|---|---:|---:|---:|---:|---:|---:|---:|"]
    sweeps = {}
    for rec in records(results_dir):
        if rec["kind"] == "train" and not rec.get("tag"):
            sweeps.setdefault(_cell(rec)[:-1], {})[rec["depth"]] = rec
    for key, recs in sorted(sweeps.items()):
        full = recs.get(None)
        if full is None or len(recs) < 2:
            continue
        L = full["layers"]
        for depth in sorted(d for d in recs if d is not None) + [None]:
            rec = recs[depth]
            ratio = lambda k: rec[k] / full[k] if full[k] else 0.0
            out.append(
                f"| {rec['arch']} | {_variant(rec)} | "
                f"{depth if depth is not None else L}/{L} | "
                f"{rec['flops_per_device']:.3e} | "
                f"{rec['bytes_per_device']:.3e} | "
                f"{rec['saved_bytes'] / 2**30:.2f} | "
                f"{ratio('flops_per_device'):.2f}x | "
                f"{ratio('bytes_per_device'):.2f}x | "
                f"{ratio('saved_bytes'):.2f}x |")
    return "\n".join(out)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "roofline"
    print({"roofline": md_roofline, "dryrun": md_dryrun,
           "perf": md_perf, "spb": md_spb}[what]())
