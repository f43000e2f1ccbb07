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

Prints the JAX driver's ``[train] step=... depth=... loss=...`` lines.  The
engine owns the state and the step table; this driver owns the loop: data,
logging, checkpoints, and the supervision loop that catches a failed step
(or the ``--fail-at`` injection), restores the latest checkpoint and
resumes.  A kernel or CUDA fault is never retried: it is raised at once.
The spatial mode, the pipeline and mesh flags and the AOT and compile
caches are not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.device import device_fault
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.policies import make_policy


def build_engine(cfg, tcfg, spb_cfg, *, depth_policy: str = "cycle",
                 time_budget: float = 0.75, device=None) -> SPBEngine:
    """The one construction path every entry point shares."""
    return SPBEngine(cfg, tcfg, spb_cfg, device=device,
                     policy=make_policy(depth_policy, cfg, spb_cfg,
                                        time_budget_frac=time_budget))


def train(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b",
                    help="yi-6b, mamba2-2.7b or recurrentgemma-2b")
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
                    help="spatial needs several GPUs and is not ported")
    ap.add_argument("--spb-k", type=int, default=4)
    ap.add_argument("--spb-warmup", type=int, default=0)
    ap.add_argument("--depth-policy", default="cycle",
                    choices=["cycle", "costmodel", "hook"],
                    help="who picks the per-step backprop depth")
    ap.add_argument("--time-budget", type=float, default=0.75,
                    help="costmodel policy: step-time budget as a fraction "
                         "of a full-backprop step")
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "randk", "lowrank"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (tests)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--use-pallas", action="store_true",
                    help="run attention and the SSD and RG-LRU scans "
                         "through the hand-written kernels (their plain "
                         "versions on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
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
                          time_budget=args.time_budget, device=args.device)
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
            if device_fault(e) or mgr is None or \
                    restarts > args.max_restarts:
                raise
            print(f"[train] FAILURE: {e}; restart {restarts}", flush=True)
            args.fail_at = -1          # don't re-inject
            args.resume = True
    if mgr:
        mgr.wait()
    return history


def _run(engine: SPBEngine, args, mgr, history):
    """Train from fresh weights, or from the latest checkpoint with
    ``--resume``; appends each step's xent to ``history`` (a failed
    attempt's entries stay)."""
    cfg, tcfg = engine.cfg, engine.tcfg
    engine.state = None             # drop a failed attempt's state first
    engine.init_state(tcfg.seed)
    start_step = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        state, start_step = mgr.restore(engine.state)
        engine.attach_state(state)
        print(f"[train] resumed from step {start_step}", flush=True)

    pipe = Pipeline(cfg, args.batch, args.seq, seed=tcfg.seed)
    t0 = time.time()
    for step in range(start_step, tcfg.num_steps):
        if step == args.fail_at:
            raise RuntimeError("injected failure")
        metrics = engine.train_step(pipe.get_batch(step), step)
        if step % args.log_every == 0 or step == tcfg.num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step={step:5d} depth={engine.last_depth!s:>4} "
                  f"loss={m['loss']:.4f} xent={m['xent']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        history.append(float(metrics["xent"]))
        if mgr and (step + 1) % tcfg.checkpoint_every == 0:
            mgr.save(engine.state, step + 1)
    return history


if __name__ == "__main__":
    train()
