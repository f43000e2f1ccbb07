"""Training driver of the port: a thin client of ``SPBEngine``.

  python -m repro_torch.launch.train --arch yi-6b --reduced --steps 8 \\
      --spb-mode temporal --spb-k 4 --use-pallas            # on the card
  python -m repro_torch.launch.train --arch mamba2-2.7b --use-pallas
  python -m repro_torch.launch.train --arch recurrentgemma-2b --use-pallas
  python -m repro_torch.launch.train --arch recurrentgemma-2b --reduced \\
      --use-pallas --device cpu     # the kernels' plain versions on the CPU

Prints the JAX driver's ``[train] step=... depth=... loss=...`` lines.
Checkpointing, restarts and the pipeline/spatial modes are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.policies import make_policy


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
    ap.add_argument("--spb-mode", default="off", choices=["off", "temporal"])
    ap.add_argument("--spb-k", type=int, default=4)
    ap.add_argument("--spb-warmup", type=int, default=0)
    ap.add_argument("--depth-policy", default="cycle", choices=["cycle"],
                    help="who picks the per-step backprop depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
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
                       seed=args.seed)
    spb_cfg = SPBConfig(mode=args.spb_mode, k=args.spb_k,
                        warmup_steps=args.spb_warmup)
    engine = SPBEngine(cfg, tcfg, spb_cfg, device=args.device,
                       policy=make_policy(args.depth_policy, cfg, spb_cfg))
    engine.init_state(tcfg.seed)
    pipe = Pipeline(cfg, args.batch, args.seq, seed=tcfg.seed)

    history = []
    t0 = time.time()
    for step in range(tcfg.num_steps):
        metrics = engine.train_step(pipe.get_batch(step), step)
        if step % args.log_every == 0 or step == tcfg.num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"[train] step={step:5d} depth={engine.last_depth!s:>4} "
                  f"loss={m['loss']:.4f} xent={m['xent']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        history.append(float(metrics["xent"]))
    return history


if __name__ == "__main__":
    train()
