"""Multi-job cluster trainer: a Scheduler drives a live SPBEngine pool on
one device (the counterpart of ``repro/launch/cluster.py``).

The paper's Fig-4 story, enacted: N tenant jobs share one card; a JigSaw
(or baseline) scheduler decides which job iterates next, on which machine
slot, at what SPB depth — and every decision executes as a real train
step through ``repro_torch.cluster.LiveBackend``.  Measured step times
feed back into the scheduler's cost model, so placements converge onto
observed hardware behavior.

  python -m repro_torch.launch.cluster --jobs 2 --machines 2 --iters 3 \\
      --workers 2 --batch 4 --seq 32 --use-pallas          # on the card
  python -m repro_torch.launch.cluster --archs yi-6b,mamba2-2.7b \\
      --device cpu          # reduced configs, the kernels' plain versions
  python -m repro_torch.launch.cluster --sim ...   # same session, DES only

Prints the reference's ``[cluster] job=...`` and ``[cluster]
scheduler=... jobs_done=...`` lines.  ``--spatial``, ``--round-quantum``,
``--fuse``, ``--aot-cache`` and ``--compilation-cache-dir`` are not
ported and raise ``NotImplementedError``.  ``--reduced`` is the default:
``--full`` asks for the published depth as well as the published widths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.cluster import (ClusterRuntime, DegradePolicy, FaultPlan,
                                 HealthMonitor, LiveBackend, SimBackend,
                                 make_live_job)
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.jigsaw.schedulers import ALL_SCHEDULERS

# flag: why it raises (the ROADMAP.md item that brings it)
_NOT_PORTED = {
    "spatial": "--spatial (disjoint submeshes) needs several GPUs: "
               "multi-GPU is ROADMAP.md Queue 1 B item 11",
    "round_quantum": "--round-quantum batches the rounds of a backend that "
                     "runs tasks concurrently (disjoint submeshes); the "
                     "one-device backend runs them one after another: "
                     "multi-GPU is ROADMAP.md Queue 1 B item 11",
    "fuse": "--fuse (horizontal fusion, engine/fused.py) needs a vmap rule "
            "on every kernel's autograd.Function: ROADMAP.md Queue 1 B "
            "item 13",
    "aot_cache": "--aot-cache (the AOT step-table cache) is ROADMAP.md "
                 "Queue 1 B item 9",
    "compilation_cache_dir": "--compilation-cache-dir (a persistent "
                             "compilation cache) is ROADMAP.md Queue 1 B "
                             "item 9",
}


def build_session(args):
    """The CLI's construction path: args -> (ClusterRuntime, backend)."""
    for flag, why in _NOT_PORTED.items():
        if getattr(args, flag, None) is not None:
            raise NotImplementedError(why)
    fault_spec = getattr(args, "fault_plan", "")
    plan = (FaultPlan.parse(fault_spec,
                            restore_s=getattr(args, "restore_s", 0.0))
            if fault_spec else None)
    health = degrade = None
    if getattr(args, "degrade", False):
        health = HealthMonitor()
        degrade = DegradePolicy()
    archs = [a for a in args.archs.split(",") if a]
    live_jobs = []
    for i in range(args.jobs):
        arch = archs[i % len(archs)]
        cfg = reduced_config(arch) if args.reduced else get_config(arch)
        if getattr(args, "use_pallas", False):
            cfg = dataclasses.replace(cfg, use_pallas=True)
        spb = SPBConfig(mode="temporal", k=max(2, args.workers))
        tcfg = TrainConfig(optimizer="adamw", learning_rate=args.lr,
                           num_steps=args.iters * args.workers,
                           seed=args.seed + i)
        live_jobs.append(make_live_job(
            i, arrival=i * args.arrival, cfg=cfg, iterations=args.iters,
            num_workers=args.workers, batch=args.batch, seq=args.seq,
            est_step_s=args.est_step, model_size_gb=args.model_gb,
            tcfg=tcfg, spb=spb))
    if args.sim:
        backend = SimBackend()
        specs = [lj.spec for lj in live_jobs]
    else:
        backend = LiveBackend(live_jobs, device=args.device,
                              verbose=not args.quiet,
                              ckpt_dir=getattr(args, "ckpt_dir", "") or None,
                              max_retries=getattr(args, "max_retries", 2))
        specs = backend.specs()
    scheduler = ALL_SCHEDULERS[args.scheduler]()
    runtime = ClusterRuntime(
        specs, scheduler, backend, num_machines=args.machines,
        machine_mem_gb=args.mem_gb, gamma=args.gamma, horizon=args.horizon,
        record_schedule=True, faults=plan,
        ckpt_every=getattr(args, "ckpt_every", 0),
        health=health, degrade=degrade)
    return runtime, backend


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--machines", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3,
                    help="iterations per job")
    ap.add_argument("--workers", type=int, default=2,
                    help="workers per job; worker j backprops (j+1)/k")
    ap.add_argument("--archs", default="yi-6b",
                    help="comma-separated arch list, cycled over jobs")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--scheduler", default="jigsaw",
                    choices=sorted(ALL_SCHEDULERS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--arrival", type=float, default=0.5,
                    help="inter-job arrival spacing (virtual seconds)")
    ap.add_argument("--est-step", type=float, default=0.5,
                    help="seed estimate of a full step (seconds); the "
                         "live feedback replaces it with measurements")
    ap.add_argument("--gamma", type=float, default=0.1,
                    help="migration cost, seconds per GB of model")
    ap.add_argument("--model-gb", type=float, default=0.01)
    ap.add_argument("--mem-gb", type=float, default=16.0)
    ap.add_argument("--horizon", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    # the flags that are not ported default to None and raise when given
    ap.add_argument("--spatial", action="store_true", default=None,
                    help="not ported (several GPUs): raises")
    ap.add_argument("--round-quantum", type=float, default=None,
                    help="not ported (concurrent rounds, several GPUs): "
                         "raises")
    ap.add_argument("--fuse", action="store_true", default=None,
                    help="not ported (horizontal fusion): raises")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="not ported: raises")
    ap.add_argument("--aot-cache", default=None, help="not ported: raises")
    ap.add_argument("--fault-plan", default="",
                    help="inject faults, ';'-separated (virtual seconds): "
                         "crash:M@T+R | slow:M@A-BxF | fail:J.W@I")
    ap.add_argument("--restore-s", type=float, default=0.0,
                    help="checkpoint-restore cost charged after a rollback")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in iterations (0 = off; "
                         "faulted jobs then restart from iteration 0)")
    ap.add_argument("--ckpt-dir", default="",
                    help="durable per-job checkpoints for the live pool "
                         "(restored onto the engine's device)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="per-task retry budget (exponential backoff) "
                         "before the job is failed gracefully; a kernel "
                         "or CUDA fault is never retried")
    ap.add_argument("--degrade", action="store_true",
                    help="attach HealthMonitor+DegradePolicy: stragglers "
                         "get shallower SPB depths instead of gang stalls")
    ap.add_argument("--sim", action="store_true",
                    help="run the same session through the DES backend "
                         "instead of live execution (no train steps)")
    ap.add_argument("--json-out", default="",
                    help="write the session summary to this path")
    ap.add_argument("--require-distinct-depths", action="store_true",
                    help="exit nonzero unless >=2 distinct SPB depths "
                         "were observed across the session (CI smoke)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run attention and the SSD and RG-LRU scans "
                         "through the hand-written kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    runtime, backend = build_session(args)
    t0 = time.time()
    res = runtime.run()
    wall = time.time() - t0

    live = isinstance(backend, LiveBackend)
    summary = backend.summary() if live else {}
    for jid in sorted(summary):
        s = summary[jid]
        # final_xent/mean_step_ms are None for a job that ran zero steps
        # (livelocked/over-horizon session) — never crash the diagnostics
        xent = (f"{s['final_xent']:.4f}" if s['final_xent'] is not None
                else "n/a")
        ms = (f"{s['mean_step_ms']:.1f}ms" if s['mean_step_ms'] is not None
              else "n/a")
        print(f"[cluster] job={jid} model={s['model']} "
              f"steps={s['steps_run']}/{s['iterations'] * s['workers']} "
              f"depths={s['depths']} xent={xent} mean_step={ms}",
              flush=True)
    distinct = sorted(set().union(
        *(set(s["depths"]) for s in summary.values())) if summary else set(),
        key=str)
    scheduled = len(runtime.jobs)
    print(f"[cluster] scheduler={args.scheduler} "
          f"jobs_done={len(res.jct)}/{scheduled} "
          f"distinct_depths={distinct} makespan={res.makespan:.2f}s "
          f"util={res.util:.3f} goodput={res.goodput:.3f} "
          f"migrations={sum(res.migrations.values())} wall={wall:.1f}s",
          flush=True)
    if live:
        print(f"[cluster] max_concurrent={backend.max_concurrent_tasks}",
              flush=True)
    if res.crashes or res.task_retries or res.failed_jobs:
        print(f"[cluster] faults: crashes={res.crashes} "
              f"retries={res.task_retries} "
              f"lost_iterations={sum(res.lost_iterations.values())} "
              f"recovery_s={sum(res.recovery_s.values()):.2f} "
              f"wasted_s={res.wasted_s:.2f} "
              f"degraded_steps={res.degraded_steps} "
              f"failed_jobs={res.failed_jobs}", flush=True)
    if args.json_out:
        rec = {"scheduler": args.scheduler, "jobs": args.jobs,
               "machines": args.machines, "makespan": res.makespan,
               "util": res.util, "jct": res.jct,
               "migrations": res.migrations,
               "goodput": res.goodput, "wasted_s": res.wasted_s,
               "crashes": res.crashes, "task_retries": res.task_retries,
               "lost_iterations": res.lost_iterations,
               "recovery_s": res.recovery_s,
               "failed_jobs": res.failed_jobs,
               "degraded_steps": res.degraded_steps, "summary": summary,
               "wall_s": wall}
        if live:
            rec.update(device=str(backend.device),
                       max_concurrent_tasks=backend.max_concurrent_tasks)
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    backend.close()

    if len(res.jct) != scheduled:
        raise SystemExit(f"only {len(res.jct)}/{scheduled} jobs completed")
    # live-only assertion: the DES never observes executed depths
    if args.require_distinct_depths and not args.sim and len(distinct) < 2:
        raise SystemExit(f"expected >=2 distinct SPB depths, saw {distinct}")
    return res


if __name__ == "__main__":
    main()
