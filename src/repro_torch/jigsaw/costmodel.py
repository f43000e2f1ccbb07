"""Task cost database for the scheduler: per-model forward and backward
time, memory and model size, and their scaling under SPB partial backprop
(the counterpart of ``repro/jigsaw/costmodel.py``).

Two sources:
  * The paper's own V100 profiles (its Table 2, batch 128): paper data,
    not a measurement of this port; they reproduce Fig 4's workload.
  * H100 profiles of the port's archs from the dry-run records
    (``launch/dryrun.py``, ``results/dryrun_torch/``): the step time is
    the max of the three roofline terms at one H100's peaks
    (``analysis/roofline.py``), counted, not measured; its
    forward:backward split is fitted over the records' SPB depths where
    there are two or more, else the reference's assumed 1:2.  Each
    profile reads the records of one layer-recompute policy ('none'
    unless asked), since the recompute moves both the step and the peak.
    :func:`h100_profile` takes the counted peak (state + temporaries),
    clamped at the card's 80 GB; :func:`hlo_profiles` keeps the
    reference's 8 and 16 GB clamps of a 16 GB TPU.

SPB scaling (paper Table 1, measured linear):
  time(frac) = fwd + frac * bwd
  mem(frac)  = mem_fwd + frac * (mem_peak - mem_fwd)
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis import roofline
from repro_torch.config import total_layers
from repro_torch.configs import FULL_WIDTH_BATCH, FULL_WIDTH_SEQ

# the reference's memory clamps (GB; a 16 GB TPU's): the state, the peak,
# the gradients
TPU_CLAMPS = (8.0, 16.0, 4.0)
# an H100's: its 80 GB for each
H100_CLAMPS = (80.0, 80.0, 80.0)

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


def _roofline_step(rec: dict) -> float:
    """A record's step on one card: the max of its three roofline terms."""
    return max(rec["flops_per_device"] / roofline.PEAK_FLOPS,
               rec["bytes_per_device"] / roofline.HBM_BW,
               rec["collective_bytes_per_device"] / roofline.LINK_BW)


def _fraction(rec: dict) -> float:
    """The SPB fraction a record counts: depth / layers, 1 at full depth."""
    return 1.0 if rec.get("depth") is None else rec["depth"] / rec["layers"]


def _config_key(rec: dict):
    """What tells two configs of one name apart in the records: a cut keeps
    its arch's name (``configs.full_width_config``), not its layers or its
    share of each MoE layer."""
    return (rec.get("name", rec["arch"]), rec.get("layers"),
            rec.get("experts_held"))


def _profile(name: str, recs: List[dict], clamps=TPU_CLAMPS
             ) -> Tuple[ModelProfile, bool]:
    """The profile of one config at one batch from its records, and
    whether its forward:backward split was counted.  The records' SPB
    fractions f give steps t(f) = fwd + f bwd: two or more fractions fit
    fwd and bwd by least squares; one fraction takes the reference's
    split, forward a third of the full step and backward two thirds, so
    a record at f is the full step times (1 + 2 f) / 3.  The memory is
    the deepest record's, state and state + temporaries, clamped at
    ``clamps`` (state, peak, gradients; GB)."""
    pts = {}
    for rec in recs:
        pts[_fraction(rec)] = _roofline_step(rec)
    fwd = bwd = None
    if len(pts) > 1:
        fs, ts = list(pts), list(pts.values())
        mf, mt = sum(fs) / len(fs), sum(ts) / len(ts)
        bwd = (sum((f - mf) * (t - mt) for f, t in zip(fs, ts))
               / sum((f - mf) ** 2 for f in fs))
        fwd = mt - bwd * mf
    counted = fwd is not None and fwd > 0 and bwd > 0
    if not counted:
        f, t = max(pts.items())
        step = t if f == 1 else t * 3 / (1 + 2 * f)
        fwd, bwd = step / 3, 2 * step / 3
    deepest = max(recs, key=_fraction)
    ma = deepest.get("memory_analysis", {})
    temp = ma.get("temp_size_in_bytes", 8 * 2 ** 30) / 2 ** 30
    args = ma.get("argument_size_in_bytes", 4 * 2 ** 30) / 2 ** 30
    state, peak, grad = clamps
    return ModelProfile(
        name=name, fwd_s=fwd, bwd_s=bwd,
        mem_fwd_gb=min(args, state), mem_peak_gb=min(args + temp, peak),
        model_size_gb=min(args, state), grad_gb=min(args / 3, grad)), counted


def _profiles(results_dir: Optional[Path], shape: str,
              keep: Callable[[dict], bool], remat: str = "none",
              clamps=TPU_CLAMPS) -> Dict[str, Tuple[ModelProfile, bool]]:
    """By name, :func:`_profile` of the ``keep`` records of ``shape``:
    of a name's records, those of the config and batch that rank first
    (the batch a JigSaw tenant runs, FULL_WIDTH_BATCH x FULL_WIDTH_SEQ,
    ``chip_smoke.py`` phases 9 and 14; else the most tokens; then the
    most layers).  Only the records of the recompute policy ``remat``
    count (a record before the policy was recorded is 'none')."""
    d = roofline.RESULTS if results_dir is None else Path(results_dir)
    if not d.exists():
        return {}
    groups: Dict[tuple, List[dict]] = {}
    for rec in roofline.records(d):
        if rec.get("shape") == shape and rec.get("mesh") == roofline.MESH \
                and rec.get("remat", "none") == remat and keep(rec):
            key = _config_key(rec) + (rec.get("batch"), rec.get("seq_len"))
            groups.setdefault(key, []).append(rec)

    def rank(key):
        _, layers, _, batch, seq = key
        return ((batch, seq) == (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ),
                (batch or 0) * (seq or 0), layers or 0)

    best: Dict[str, tuple] = {}
    for key in groups:
        if key[0] not in best or rank(key) > rank(best[key[0]]):
            best[key[0]] = key
    return {name: _profile(name, groups[key], clamps)
            for name, key in best.items()}


def hlo_profiles(results_dir: Optional[Path] = None,
                 shape: str = "train_4k") -> Dict[str, ModelProfile]:
    """Per-config profiles from the dry run's train records of ``shape``
    (one card's roofline, default directory ``roofline.RESULTS``), keyed
    by the config's name (:func:`_profiles` picks a name's config and
    batch, :func:`_profile` its split).  A name can stand for several
    cuts: :func:`h100_profile` takes one config's own."""
    return {name: p for name, (p, _) in
            _profiles(results_dir, shape, lambda rec: True).items()}


def h100_profile(cfg, results_dir: Optional[Path] = None,
                 shape: str = "train_4k", remat: str = "none"
                 ) -> Tuple[Optional[ModelProfile], bool]:
    """``cfg``'s own profile from the dry run's records under the
    recompute policy ``remat``, those of its name, its layers and its
    share of each MoE layer (None when there is none), and whether its
    forward:backward split was counted (records at two or more depths)
    rather than assumed.  Its memory is the counted peak, clamped at the
    card's 80 GB."""
    held = cfg.moe.experts_held if cfg.moe else None
    key = (cfg.name, total_layers(cfg), held)
    got = _profiles(results_dir, shape,
                    lambda rec: _config_key(rec) == key, remat,
                    H100_CLAMPS).get(cfg.name)
    return got if got is not None else (None, False)


def profile_db(use_hlo: bool = True) -> Dict[str, ModelProfile]:
    """Profiles by model name: the paper's V100 table, and with
    ``use_hlo`` the dry run's H100 profiles over it."""
    db = v100_profiles()
    if use_hlo:
        db.update(hlo_profiles())
    return db


def spb_worker_fractions(num_workers: int,
                         k: Optional[int] = None) -> List[float]:
    """Paper worker assignment: worker j of k backprops (j+1)/k of the
    layers (j taken mod k)."""
    k = k or num_workers
    return [(j % k + 1) / k for j in range(num_workers)]
