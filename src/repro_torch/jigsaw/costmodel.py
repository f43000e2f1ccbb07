"""Task cost database for the scheduler: per-model forward and backward
time, memory and model size, and their scaling under SPB partial backprop
(the counterpart of ``repro/jigsaw/costmodel.py``).

The profiles are the paper's own V100 measurements (its Table 2, batch
128): paper data, not a measurement of this port.  The reference also
derives TPU profiles of its architectures from dry-run records
(``hlo_profiles``); the port writes no such records yet (ROADMAP.md Queue
1 B item 14), so :func:`profile_db` is the V100 table alone -- which is also
what the reference returns in this repository, where no dry-run records
exist.

SPB scaling (paper Table 1, measured linear):
  time(frac) = fwd + frac * bwd
  mem(frac)  = mem_fwd + frac * (mem_peak - mem_fwd)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

# --- Paper Table 2 (V100, batch 128): times ms, mem GB, grad MB ---
V100_PROFILES = {
    # name: (fwd_ms, fwd_mem, bwd_ms, bwd_mem, grad_mb)
    "resnet18": (9.19, 0.05, 21.49, 2.46, 44),
    "resnet34": (16.11, 0.08, 36.69, 3.08, 85),
    "resnet50": (36.32, 0.09, 78.9, 7.33, 94),
    "resnet101": (60.51, 0.17, 135.14, 9.79, 170),
    "resnet152": (86.9, 0.23, 197.05, 12.81, 232),
    "vgg19": (6.82, 0.08, 16.31, 2.02, 80),
    "vgg16": (5.68, 0.06, 13.96, 1.97, 59),
    "vgg11": (3.34, 0.04, 7.8, 1.83, 36),
    "googlenet": (41.33, 0.05, 99.17, 5.96, 24),
}


@dataclass
class ModelProfile:
    name: str
    fwd_s: float
    bwd_s: float
    mem_fwd_gb: float
    mem_peak_gb: float
    model_size_gb: float
    grad_gb: float

    def task_time(self, spb_fraction: float) -> float:
        return self.fwd_s + spb_fraction * self.bwd_s

    def task_mem(self, spb_fraction: float) -> float:
        return self.mem_fwd_gb + spb_fraction * (
            self.mem_peak_gb - self.mem_fwd_gb)

    def grad_bytes(self, spb_fraction: float) -> float:
        return self.grad_gb * 2 ** 30 * spb_fraction


def v100_profiles() -> Dict[str, ModelProfile]:
    out = {}
    for name, (f_ms, f_gb, b_ms, b_gb, g_mb) in V100_PROFILES.items():
        out[name] = ModelProfile(
            name=name, fwd_s=f_ms / 1e3, bwd_s=b_ms / 1e3,
            mem_fwd_gb=f_gb + 0.5,               # + weights/workspace floor
            mem_peak_gb=f_gb + b_gb + 0.5,
            model_size_gb=g_mb / 1024.0,         # params ~ grad size
            grad_gb=g_mb / 1024.0)
    return out


def profile_db() -> Dict[str, ModelProfile]:
    """Profiles by model name: the paper's V100 table."""
    return v100_profiles()


def spb_worker_fractions(num_workers: int,
                         k: Optional[int] = None) -> List[float]:
    """Paper worker assignment: worker j of k backprops (j+1)/k of the
    layers (j taken mod k)."""
    k = k or num_workers
    return [(j % k + 1) / k for j in range(num_workers)]
