"""Philly-like DLT workload generator (paper §4.2 'Workload').
(The counterpart of ``repro/jigsaw/trace.py``, the same code.)

~500 jobs, Poisson arrivals (mean 30s), worker-count mix
{1: 50%, 2: 10%, 4: 20%, 8: 15%, 16: 5%}, iteration counts spanning short
fine-tunes to long runs, models drawn from the profile DB.  With
``spb=True`` worker j of a k-worker job backprops fraction (j+1)/k (the
paper's assignment) — its task duration/memory shrink accordingly; with
``spb=False`` every worker does full backprop (what the gang baselines
run, since their APIs assume symmetric workers).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

from repro_torch.jigsaw.costmodel import ModelProfile, profile_db
from repro_torch.jigsaw.simulator import JobSpec, WorkerSpec

WORKER_MIX = [(1, 0.50), (2, 0.10), (4, 0.20), (8, 0.15), (16, 0.05)]


def _sample_workers(rng: random.Random) -> int:
    r = rng.random()
    acc = 0.0
    for w, p in WORKER_MIX:
        acc += p
        if r <= acc:
            return w
    return 16


def generate_trace(num_jobs: int = 500, *, seed: int = 0,
                   mean_arrival_s: float = 30.0, spb: bool = True,
                   db: Optional[Dict[str, ModelProfile]] = None,
                   min_iters: int = 50, max_iters: int = 400) -> List[JobSpec]:
    rng = random.Random(seed)
    db = db or profile_db()
    names = sorted(db)
    jobs: List[JobSpec] = []
    t = 0.0
    for jid in range(num_jobs):
        t += rng.expovariate(1.0 / mean_arrival_s)
        model = db[rng.choice(names)]
        k = _sample_workers(rng)
        iters = int(rng.uniform(min_iters, max_iters))
        workers = []
        for j in range(k):
            frac = (j + 1) / k if (spb and k > 1) else 1.0
            workers.append(WorkerSpec(duration=model.task_time(frac),
                                      memory=model.task_mem(frac),
                                      frac=frac))
        jobs.append(JobSpec(job_id=jid, arrival=t, model=model.name,
                            model_size_gb=model.model_size_gb,
                            iterations=iters, workers=workers))
    return jobs
