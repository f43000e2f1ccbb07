"""Training driver of the port: a thin client of ``SPBEngine`` with
checkpointing and restart (the one-device surface of
``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch yi-6b --reduced --steps 8 \\
      --spb-mode temporal --spb-k 4 --use-pallas            # on the card
  python -m repro_torch.launch.train --arch mamba2-2.7b --use-pallas \\
      --spb-mode temporal-mb --batch 8                      # k-cycle a step
  python -m repro_torch.launch.train --spb-mode temporal \\
      --depth-policy costmodel --time-budget 0.6
  python -m repro_torch.launch.train --steps 8 --checkpoint-dir ckpt \\
      --checkpoint-every 4 --fail-at 5     # one injected failure, resumed
  python -m repro_torch.launch.train --arch recurrentgemma-2b --reduced \\
      --use-pallas --device cpu     # the kernels' plain versions on the CPU
  python -m repro_torch.launch.train --arch seamless-m4t-medium --reduced \\
      --steps 2 --spb-mode temporal --use-pallas --device cpu  # enc-dec
  python -m repro_torch.launch.train --spb-mode temporal --remat full \\
      --device cpu          # recompute each live repeat in the backward
  python -m repro_torch.launch.train --spb-mode spatial --spb-k 2 \\
      --data-parallel 4 --device cpu   # 4 ranks, a depth each, over gloo
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --spb-mode temporal --data-parallel 4   # the group from torchrun
  python -m repro_torch.launch.train --parallelism pipeline \\
      --pipeline-stages 2 --microbatches 4 --spb-mode temporal \\
      --device cpu          # 2 stage ranks, 1F1B, SPB-truncated stages

Prints the JAX driver's ``[train] step=... depth=... loss=...`` lines.  The
engine owns the state and the step table; this driver owns the loop: data,
logging, checkpoints, and the supervision loop that catches a failed step
(or the ``--fail-at`` injection), restores the latest checkpoint and
resumes.  A kernel or CUDA fault is never retried: it is raised at once.
``--aot-cache DIR`` trains through the step table: a stored table under
``DIR`` is loaded (the kernel libraries without ``nvcc``; on the card one
CUDA graph a depth, captured in-process), else it is built and stored
there.  ``--compilation-cache-dir DIR`` builds and loads the kernel
libraries in ``DIR`` and reports what it found there (``[cc] ...``).
``--remat {none,dots,full}`` is the layer recompute of every step the
engine builds (default none; the reference's ``REMAT`` defaults to full,
which this flag reaches).

``--data-parallel N`` trains on a data group of N ranks
(``launch/mesh.py``): spawned on this machine, or, under ``torchrun``,
the group it started (the flag must then agree with it).  Every rank
draws the seeded global batch of ``--batch`` rows and takes its own rows
(``DataGroup.shard``; ``--batch`` must divide by N, and by N x k for
temporal-mb); only rank 0 logs.  ``--spb-mode spatial`` gives rank r the
depth of level ``r % k`` and weights the gradients per layer; the other
modes average what has a gradient.  The engine keeps the reference's
ZeRO-1 layout: each rank holds its slice of the optimizer state.

Checkpoints and restart work under a group too.  Rank 0 writes the whole
state (``SPBEngine.gathered_state``, collective) in the one-process
format, so a group's checkpoint restores into one process or a group of
another size.  On ``--resume`` rank 0 waits for its own write in flight,
picks the step and broadcasts it; every rank then reads that checkpoint
and keeps its slice.  ``--fail-at`` is raised by every rank at the same
step, and the supervision loop restarts them together; any other failure
of a rank is raised, which ends the group (``mesh.spawn`` ends the other
ranks, as torchrun does), and a rerun with ``--resume`` continues.  The
step table (``--aot-cache``) is refused under a group of several ranks.

``--parallelism pipeline`` runs the stack as a pipeline of
``--pipeline-stages`` S stage ranks times ``--pipeline-data-parallel`` D
data ranks times ``--tensor-parallel`` T model ranks
(``launch/mesh.init_pipe_group``; spawned on this machine, or torchrun's
S x D x T ranks), interpreting the ``--pipeline-schedule`` table
(``1f1b`` or ``gpipe``) over ``--microbatches`` M.  SPB depths snap to
stage boundaries, and the stages below the depth run forward only.  Every
rank draws the seeded global batch and takes its data index's rows of
each microbatch (``--batch`` must divide by M x D); only rank 0 logs.
Checkpoints, ``--resume`` and ``--fail-at`` work as under a data group
(the checkpoint is the one-process format).  ``--tensor-parallel`` above
1 column/row-shards the stages' weights over the T model ranks,
``--sequence-parallel`` also shards the in-stage residual stream over
them on the sequence dim, and ``--zero2`` reduce-scatters the stage
gradients over the data ranks into the ZeRO-1 moments' layout, with the
reference's meanings.  ``temporal-mb`` and ``spatial`` raise under a
pipeline, as in the reference; so do a tensor-parallel degree the
config's heads or FFN width do not divide, a stack other than dense
attention, and ``--sequence-parallel`` without ``--tensor-parallel``
above 1, with the reference's texts.  Outside a pipeline the three knobs
raise, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import device_fault
from repro_torch.dist import steps as steps_lib
from repro_torch.engine import stepcache
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.policies import make_policy
from repro_torch.launch import mesh
from repro_torch.models import lm


def build_engine(cfg, tcfg, spb_cfg, *, depth_policy: str = "cycle",
                 time_budget: float = 0.75, device=None,
                 remat: str = "none", group=None,
                 parallelism: str = "spmd",
                 pipeline_schedule: str = "1f1b",
                 tensor_parallel: Optional[int] = None,
                 sequence_parallel: bool = False,
                 zero2: bool = False) -> SPBEngine:
    """The one construction path every entry point shares."""
    if parallelism == "pipeline":   # the policy snaps to stage boundaries
        spb_cfg = dataclasses.replace(spb_cfg,
                                      pipeline_stages=group.num_stages)
    return SPBEngine(cfg, tcfg, spb_cfg,
                     device=None if group is not None else device,
                     remat=remat, group=group, parallelism=parallelism,
                     pipeline_schedule=pipeline_schedule,
                     tensor_parallel=tensor_parallel,
                     sequence_parallel=sequence_parallel, zero2=zero2,
                     policy=make_policy(depth_policy, cfg, spb_cfg,
                                        time_budget_frac=time_budget,
                                        remat=remat))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b",
                    help="a registered arch (repro_torch.configs.ARCHS)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--spb-mode", default="off",
                    choices=["off", "temporal", "temporal-mb", "spatial"],
                    help="spatial: one depth a rank of --data-parallel")
    ap.add_argument("--spb-k", type=int, default=4)
    ap.add_argument("--spb-warmup", type=int, default=0)
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="ranks of the data group (default: torchrun's "
                         "WORLD_SIZE, else 1); spawned on this machine "
                         "unless torchrun started them")
    ap.add_argument("--parallelism", default="spmd",
                    choices=["spmd", "pipeline"],
                    help="pipeline: run the layer stack as a schedule-"
                         "driven pipeline, one stage a rank")
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="pipeline stage count (default: torchrun's "
                         "WORLD_SIZE over --pipeline-data-parallel, else 2)")
    ap.add_argument("--pipeline-schedule", default="1f1b",
                    choices=["1f1b", "gpipe"])
    ap.add_argument("--pipeline-data-parallel", type=int, default=1,
                    help="ranks on the pipeline's data axis: each "
                         "microbatch's rows split over them, and each "
                         "stage's optimizer state ZeRO-1-shards over them")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="size of the pipeline's 'model' axis: stage "
                         "weights column/row-shard over it with explicit "
                         "collectives at the attention/MLP joins")
    ap.add_argument("--sequence-parallel", action="store_true",
                    help="with --tensor-parallel > 1: shard the in-stage "
                         "residual stream over 'model' on the sequence dim "
                         "(all-gather/reduce-scatter at the joins)")
    ap.add_argument("--zero2", action="store_true",
                    help="reduce-scatter pipeline stage grads over 'data' "
                         "into the ZeRO-1 moments' layout")
    ap.add_argument("--depth-policy", default="cycle",
                    choices=["cycle", "costmodel", "hook"],
                    help="who picks the per-step backprop depth")
    ap.add_argument("--time-budget", type=float, default=0.75,
                    help="costmodel policy: step-time budget as a fraction "
                         "of a full-backprop step")
    ap.add_argument("--aot-cache", default="",
                    help="step-table root: a process with the same config "
                         "and device loads the stored table instead of "
                         "building it")
    ap.add_argument("--compilation-cache-dir", default="",
                    help="kernel-library directory: libraries persist "
                         "across processes")
    ap.add_argument("--remat", default="none", choices=lm.REMAT_POLICIES,
                    help="layer recompute of the live layers in the "
                         "backward (the reference's REMAT values)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "randk", "lowrank"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (tests; every rank "
                         "of a group raises it)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--use-pallas", action="store_true",
                    help="run attention and the SSD and RG-LRU scans "
                         "through the hand-written kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _check_group_args(args, n: int) -> None:
    """What a data group of ``n`` ranks refuses, raised before any rank
    starts."""
    if n < 1:
        raise ValueError(f"--data-parallel {n}: need at least one rank")
    if n == 1:
        return
    if args.aot_cache:
        raise NotImplementedError(
            f"--aot-cache with --data-parallel {n}: the step table under a "
            f"data group is not ported (its collectives run on the host, "
            f"which a CUDA graph cannot capture; ROADMAP.md Queue 1 B item "
            f"11)")
    chunks = args.spb_k if args.spb_mode == "temporal-mb" else 1
    if args.batch % (n * chunks):
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"--data-parallel {n}" + (
                             f" x {chunks} microbatches" if chunks > 1
                             else ""))


def _config(args):
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    return dataclasses.replace(cfg, use_pallas=True) if args.use_pallas \
        else cfg


def _check_pipeline_args(args, under_torchrun: bool):
    """The pipeline's grid ``(S, D, T)``, raised on what a pipeline
    refuses before any rank starts."""
    d, t = args.pipeline_data_parallel, max(1, args.tensor_parallel)
    steps_lib.check_pipeline_knobs(_config(args), t, args.sequence_parallel)
    s = args.pipeline_stages or (
        int(os.environ["WORLD_SIZE"]) // (d * t) if under_torchrun else 2)
    if args.spb_mode in ("spatial", "temporal-mb"):
        raise ValueError(f"SPB mode {args.spb_mode!r} is not supported "
                         f"under pipeline parallelism (use 'temporal' or "
                         f"'off')")
    if args.data_parallel not in (None, 1):
        raise ValueError("--data-parallel is the spmd group's; a pipeline "
                         "takes --pipeline-data-parallel")
    if args.aot_cache:
        raise NotImplementedError(
            "--aot-cache under a pipeline: its messages go through the "
            "host, which a CUDA graph cannot capture")
    m = max(1, args.microbatches)
    if args.batch % (m * d):
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{m} microbatches x {d} data ranks")
    if args.sequence_parallel and args.seq % t:
        raise ValueError(f"sequence length {args.seq} not divisible by "
                         f"tensor_parallel={t}")
    return s, d, t


def train(argv=None):
    """Parse ``argv`` and train; returns rank 0's per-step xent."""
    args = parse_args(argv)
    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if args.parallelism == "pipeline":
        s, d, t = _check_pipeline_args(args, under_torchrun)
        if s * d * t > 1 and not under_torchrun:
            return mesh.spawn("repro_torch.launch.train:rank_main",
                              s * d * t, args, device=args.device,
                              grid=(s, d, t))[0]
        group = mesh.init_pipe_group(s, d, t, device=args.device)
        try:
            return rank_main(group, args)
        finally:
            group.close()
    steps_lib.refuse_pipeline_knobs(args.tensor_parallel,
                                    args.sequence_parallel, args.zero2)
    n = int(os.environ["WORLD_SIZE"]) if under_torchrun and \
        args.data_parallel is None else (args.data_parallel or 1)
    _check_group_args(args, n)
    if n > 1 and not under_torchrun:
        return mesh.spawn("repro_torch.launch.train:rank_main", n, args,
                          device=args.device)[0]
    group = mesh.init_data_group(n, device=args.device)
    try:
        return rank_main(group, args)
    finally:
        group.close()


def rank_main(group, args: argparse.Namespace) -> list:
    """One rank's training run (the whole run on a group of one); returns
    its per-step xent."""
    cc_before = None
    if args.compilation_cache_dir:
        cc_before = stepcache.enable_persistent_compilation_cache(
            args.compilation_cache_dir)
    cfg = _config(args)
    tcfg = TrainConfig(learning_rate=args.lr, optimizer=args.optimizer,
                       num_steps=args.steps, microbatches=args.microbatches,
                       compression=args.compression,
                       checkpoint_every=args.checkpoint_every,
                       checkpoint_dir=args.checkpoint_dir, seed=args.seed)
    spb_cfg = SPBConfig(mode=args.spb_mode, k=args.spb_k,
                        warmup_steps=args.spb_warmup)
    # built once, outside the supervision loop: a configuration it refuses
    # is no step failure
    engine = build_engine(cfg, tcfg, spb_cfg, depth_policy=args.depth_policy,
                          time_budget=args.time_budget, device=args.device,
                          remat=args.remat, group=group,
                          parallelism=args.parallelism,
                          pipeline_schedule=args.pipeline_schedule,
                          tensor_parallel=args.tensor_parallel,
                          sequence_parallel=args.sequence_parallel,
                          zero2=args.zero2)
    mgr = (CheckpointManager(tcfg.checkpoint_dir, keep=3)
           if tcfg.checkpoint_dir else None)

    restarts = 0
    history = []
    while True:
        try:
            history = _run(engine, args, mgr, history)
            break
        except RuntimeError as e:      # noqa: PERF203
            restarts += 1
            # a group restarts together only from what every rank raised
            # at once; a failure of one rank ends the group
            alone = group.size > 1 and not isinstance(e, InjectedFailure)
            if device_fault(e) or alone or mgr is None or \
                    restarts > args.max_restarts:
                raise
            if group.rank == 0:
                print(f"[train] FAILURE: {e}; restart {restarts}",
                      flush=True)
            args.fail_at = -1          # don't re-inject
            args.resume = True
    if mgr:
        mgr.wait()
    group.barrier()         # every rank returns once the last write is done
    if cc_before is not None and group.rank == 0:
        print(stepcache.persistent_cache_report(
            args.compilation_cache_dir, cc_before), flush=True)
    return history


class InjectedFailure(RuntimeError):
    """The ``--fail-at`` failure, which every rank of a group raises at the
    same step."""


def _run(engine: SPBEngine, args, mgr, history):
    """Train from fresh weights, or from the latest checkpoint with
    ``--resume``; appends each step's xent to ``history`` (a failed
    attempt's entries stay).  Each rank of a data group takes its rows of
    every global batch; rank 0 writes the checkpoints."""
    cfg, tcfg = engine.cfg, engine.tcfg
    group = engine.group
    engine.state = None             # drop a failed attempt's state first
    engine.init_state(tcfg.seed)
    start_step = 0
    if args.resume and mgr:
        latest = None
        if group.rank == 0:
            mgr.wait()  # the failed attempt's last write, still in flight
            latest = mgr.latest_step()
        latest = group.broadcast_int(latest)    # one step for every rank
        if latest is not None:
            state, start_step = mgr.restore(engine.state_shapes, latest)
            engine.attach_state(state)
            if group.rank == 0:
                print(f"[train] resumed from step {start_step}", flush=True)

    pipe = Pipeline(cfg, args.batch, args.seq, seed=tcfg.seed)
    if args.aot_cache and not engine._compiled:
        specs = engine.batch_specs_like(pipe.get_batch(0))
        path = engine.aot_cache_path(specs, args.aot_cache)
        if engine.load_aot(path):
            print(f"[train] AOT step table loaded from {path} "
                  f"(no re-trace)", flush=True)
        else:
            engine.compile_table(specs)
            engine.export_aot(path)
            print(f"[train] AOT step table compiled + exported to {path}",
                  flush=True)
    chunks = args.spb_k if args.spb_mode == "temporal-mb" else 1
    if engine.pipeline_stages:      # a data index's rows of each microbatch
        chunks = max(1, tcfg.microbatches)
    t0 = time.time()
    for step in range(start_step, tcfg.num_steps):
        if step == args.fail_at:
            raise InjectedFailure("injected failure")
        metrics = engine.train_step(
            group.shard(pipe.get_batch(step), chunks), step)
        if group.rank == 0 and (step % args.log_every == 0
                                or step == tcfg.num_steps - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step={step:5d} depth={engine.last_depth!s:>4} "
                  f"loss={m['loss']:.4f} xent={m['xent']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        history.append(float(metrics["xent"]))
        if mgr and (step + 1) % tcfg.checkpoint_every == 0:
            whole = engine.gathered_state()         # collective
            if group.rank == 0:
                mgr.save(whole, step + 1)
    return history


if __name__ == "__main__":
    train()
