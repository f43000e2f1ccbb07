"""Serving client of the port: replays an arrival trace through the
continuous-batching :class:`~repro_torch.serve.ServeEngine`
(``repro/launch/serve.py``).

The engine owns params, the paged KV cache and the decode step; this
driver is only a client -- it generates prompts, schedules arrivals
(deterministic every-N-steps or a seeded Poisson process), pumps the
engine and reports per-request latency + throughput.

  python -m repro_torch.launch.serve --device cpu --arch yi-6b \\
      --requests 6 --arrive-every 3          # reduced, plain versions
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full \\
      --use-pallas --max-context 2048        # published widths, the card

The reduced configs' prompts come from the same ``MarkovLM`` stream as
the reference's, so both drivers serve the same prompts.  With ``--full``
they are uniform random tokens from ``configs.make_batch``'s seeded
generator instead: ``MarkovLM`` builds a vocab x vocab float64 table
(33 GB at yi-6b's 64000).

``--aot-cache DIR`` serves through the step table: a stored table under
``DIR`` is loaded (its kernel libraries without ``nvcc``, its CUDA graphs
captured in-process), else the table is built and stored there.
``--compilation-cache-dir DIR`` builds and loads the kernel libraries in
``DIR`` and reports what it found there (``[cc] ...``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.configs import get_config, make_batch, reduced_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.engine import stepcache
from repro_torch.serve import ServeEngine, default_geometry


def _arrival_steps(args) -> list:
    """Engine-step arrival times for each request (deterministic trace)."""
    if args.poisson > 0:
        rng = np.random.default_rng(args.seed + 7)
        gaps = rng.exponential(1.0 / args.poisson, size=args.requests)
        return np.floor(np.cumsum(gaps)).astype(int).tolist()
    return [i * args.arrive_every for i in range(args.requests)]


def _prompts(cfg, args) -> list:
    if args.reduced:
        gen = MarkovLM(cfg.vocab_size, seed=args.seed)
        return gen.sample(args.requests, args.prompt_len + 1,
                          step=0)[:, :args.prompt_len].tolist()
    return make_batch(cfg, args.requests, args.prompt_len, seed=args.seed,
                      device="cpu")["tokens"].tolist()


def serve(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--arrive-every", type=int, default=3,
                    help="deterministic trace: request i arrives at "
                         "engine step i*N (requests overlap mid-decode)")
    ap.add_argument("--poisson", type=float, default=0.0,
                    help="mean arrivals per engine step; overrides "
                         "--arrive-every with a seeded Poisson trace")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--watermark", type=float, default=1.0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (placement-invariant outputs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poll-every", type=int, default=2)
    ap.add_argument("--aot-cache", default=None,
                    help="step-table root: load the serve table if "
                         "present, else build (capture) and store it")
    ap.add_argument("--compilation-cache-dir", default="",
                    help="kernel-library directory: libraries persist "
                         "across processes")
    ap.add_argument("--use-pallas", action="store_true",
                    help="prefill attention through the hand-written "
                         "kernels (their plain versions on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cc_before = None
    if args.compilation_cache_dir:
        cc_before = stepcache.enable_persistent_compilation_cache(
            args.compilation_cache_dir)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    geom = default_geometry(num_slots=args.slots, page_size=args.page_size,
                            max_context=args.max_context)
    engine = ServeEngine(cfg, geom=geom, seed=args.seed,
                         watermark=args.watermark, device=args.device)
    print(f"[serve] arch={cfg.name} device={engine.device} "
          f"slots={geom.num_slots} page={geom.page_size} "
          f"pool={geom.num_pages - 1} pages buckets={list(engine.buckets)}",
          flush=True)

    if args.aot_cache:
        path = engine.aot_cache_path(args.aot_cache)
        if engine.load_aot(path):
            print(f"[serve] serve AOT table loaded from {path} (no retrace)",
                  flush=True)
        else:
            engine.compile_table()
            engine.export_aot(path)
            print(f"[serve] serve AOT table compiled + exported to {path}",
                  flush=True)

    pending = deque(zip(_arrival_steps(args), _prompts(cfg, args)))
    done, total = [], args.requests
    t0 = time.time()
    while pending or engine.scheduler.queue or engine._live:
        while pending and pending[0][0] <= engine.clock:
            _, prompt = pending.popleft()
            engine.submit(prompt, max_new=args.max_new,
                          temperature=args.temperature)
        engine.step(1)
        if engine.scheduler.queue or engine.clock % args.poll_every == 0:
            done.extend(engine.poll())
    done.extend(engine.poll())
    wall = time.time() - t0

    for req in sorted(done, key=lambda r: r.rid):
        print(f"[serve] req {req.rid}: {len(req.output)} tok, arrived "
              f"step {req.arrived_step}, admitted {req.admitted_step}, "
              f"finished {req.finished_step} "
              f"(latency {req.finished_step - req.arrived_step} steps)")
    st = engine.stats()
    new_tokens = sum(len(r.output) for r in done)
    print(f"[serve] completed={len(done)}/{total} steps={engine.clock} "
          f"decode_steps={st['decode_steps']} "
          f"tokens/s={new_tokens / max(wall, 1e-9):.1f}")
    print(f"[serve] slots_reused={st['slots_reused']} "
          f"slot_uses={st['slot_uses']} pages_alloc={st['page_allocs']} "
          f"pages_freed={st['page_frees']} free_pages={st['free_pages']}",
          flush=True)
    if cc_before is not None:
        print(stepcache.persistent_cache_report(
            args.compilation_cache_dir, cc_before), flush=True)
    return done


if __name__ == "__main__":
    serve()
