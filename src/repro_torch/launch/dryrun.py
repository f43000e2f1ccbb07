"""Dry run: count one step of an (arch x shape) cell on the meta device and
record its work, memory and roofline inputs (the counterpart of
``repro/launch/dryrun.py``).

  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
      --full-width --batch 2 --seq 2048 --depth 2   # what one card runs
  python -m repro_torch.launch.dryrun --arch yi-6b --reduced \\
      --shape train_4k --batch 2 --seq 64 --depth 2
  python -m repro_torch.launch.dryrun --all         # every cell, cached
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
      --full-width --batch 2 --seq 2048 --depth 8 --remat full
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \
      --full-width --layers 4 --batch 2 --seq 2048 --depth 4 \
      --data-parallel 2         # one rank of two, ZeRO-1
  python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b \
      --shape train_4k --full-width --layers 3 --batch 2 --seq 2048 \
      --model-parallel 2        # one rank of a (1, 2) grid, experts over 2

The step always runs on the meta device, as the reference's runs on fake
host devices: nothing is computed or allocated, so it needs no card and
touches none.  ``train`` counts ``dist/steps.make_train_step`` at the SPB
suffix ``--depth`` (snapped to a unit boundary, as the engine snaps it;
the full depth is recorded as None, full backprop) with the engine's
temporal k=4 SPB config and AdamW; ``prefill`` counts ``lm.prefill`` and
``decode`` ``lm.decode_step``, each over a dense cache of the shape's
length.  Each runs the config's ``use_pallas``: on meta tensors the
kernels' wrappers count their kernel's work
(``kernels/_build.meta_launch``) and launch nothing.  ``--remat`` sets
the train step's layer recompute ('none', the port's default, 'dots' or
'full', the reference's values): the recompute runs in the counted
backward, and ``saved_bytes`` counts what the checkpoints keep
(``analysis/cost.py``).  ``--data-parallel N`` counts one rank of a
data group of N: its share of the batch, its state under the ZeRO-1
layout (``--no-zero1``: replicated; ``dist/sharding.state_pspec``), and
the group's collectives, which the group reports on the meta device
instead of running them (``dist/group.META_SINKS``), by the ring model;
the record then also holds the rank's state bytes both ways
(``sharding.sharded_state_bytes``) and the predicted peak (state and
batch plus the counted temporaries).  ``--model-parallel T`` counts one
rank of the ``(N, T)`` grid (``dist/group.GridGroup``): a MoE config runs
``impl="ep"`` with ``E / T`` experts a rank (``experts_held``), as the
reference's ``lower_cell`` forces ``impl="ep"`` on its mesh, and the
model group's collectives, the all-to-all among them (``(T - 1) / T`` of
its payload on the wire), go into the collective bytes and so into the
roofline's link term; the state is laid out by
``sharding.grid_state_pspec``.  At T = 1 nothing changes.  A prefill or
decode cell under ``--model-parallel T`` and ``--data-parallel n`` counts
one rank of the ``(n, T)`` serving grid (``dist/steps.shard_decode_step``):
its ``B / n`` rows, an attn/local layer's ``H / T`` heads and a dense
FFN's ``d_ff / T`` columns (``sharding.serve_params_pspec``), its share of
the dense cache (``sharding.grid_cache_pspec``), and the model group's
all-reduces of the row-parallel joins (``roofline.serve_tp_calls``) in
the collective bytes; the record holds the rank's ``param_bytes`` and
``cache_bytes``.

Records: one JSON a cell under ``results/dryrun_torch/``
(``analysis/roofline.cell_path``; ``--force`` recomputes) with the
reference's keys, ``mesh`` = ``"h100"`` and ``chips`` = 1, plus the cut,
the batch, the recompute policy (``remat``; a policy other than 'none'
names its own file) and the per-kernel counts.  ``analysis/report.py`` renders
them, ``jigsaw/costmodel.hlo_profiles`` and ``h100_profile`` read the
train records.  The
dry run runs on the meta device, where nothing executes, so it captures
no CUDA graph and stores no step table (the reference exports its AOT
executables; the port's table is built on the card, ``engine/aot.py``);
``--multi-pod`` and sharding-rule overrides need meshes the port does not
build and raise, naming item 11.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional

from repro_torch.analysis import cost
from repro_torch.analysis import roofline
from repro_torch.config import (SHAPES, SPBConfig, TrainConfig, snap_depth,
                                total_layers)
from repro_torch.configs import (cells, cut_config, decode_token_specs,
                                 get_config, input_specs, shape_skip_reason)
import torch

from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup, ModelGroup
from repro_torch.models import lm
from repro_torch.serve import kvcache
from repro_torch.tree import tree_map


def one_card(multi_pod: bool = False, zero1: bool = True,
             rules_extra=None) -> None:
    """Raise for the reference's mesh options the port has no mesh for:
    the dry run counts one card, or one rank of a data group (``zero1``
    either way)."""
    what = ("the multi-pod mesh" if multi_pod else
            "sharding-rule overrides" if rules_extra else None)
    if what:
        raise NotImplementedError(
            f"{what} needs a mesh the port does not build yet; it comes "
            f"with the production meshes, the next slice of ROADMAP.md "
            f"Queue 1 B item 11")


def spb_depth(cfg, depth: Optional[int]) -> Optional[int]:
    """``depth`` snapped as the engine snaps it; the full depth is None."""
    if depth is None:
        return None
    depth = snap_depth(cfg, depth)
    return None if depth == total_layers(cfg) else depth


def count_cell(arch: str, shape_name: str, *, cut: str = "published",
               depth: Optional[int] = None, batch: Optional[int] = None,
               seq_len: Optional[int] = None, multi_pod: bool = False,
               zero1: bool = True, rules_extra=None,
               remat: str = "none", data_parallel: int = 1,
               layers: Optional[int] = None, model_parallel: int = 1
               ) -> dict:
    """Count one cell on the meta device; returns its record (without
    ``ok``/``tag``).  ``batch``/``seq_len`` default to the shape's (the
    global batch); ``remat`` is a train step's recompute policy;
    ``data_parallel`` n > 1 counts one rank of a data group of n, its
    optimizer state ZeRO-1 sharded unless ``zero1`` is off; ``layers``
    cuts the config's depth further (a dense decoder's);
    ``model_parallel`` T > 1 counts one rank of the ``(data_parallel, T)``
    grid, a MoE config's experts sharded over T by expert parallelism, and
    in a prefill or decode cell an attn/local layer's heads and a dense
    FFN's columns too (the serving grid's layout)."""
    one_card(multi_pod, zero1, rules_extra)
    remat = lm.resolve_remat(remat)
    cfg = cut_config(arch, cut)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    T = model_parallel
    whole = cfg                 # the grid's layout: every expert
    if T > 1 and cfg.moe is not None:
        if cfg.moe.num_experts % T:
            raise ValueError(f"--model-parallel {T} does not divide the "
                             f"{cfg.moe.num_experts} experts of {arch}")
        whole = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep", experts_held=None))
        cfg = dataclasses.replace(whole, moe=dataclasses.replace(
            whole.moe, experts_held=cfg.moe.num_experts // T))
    model = ModelGroup(rank=0, size=T) if T > 1 else None
    sh = SHAPES[shape_name]
    B = sh.global_batch if batch is None else batch
    S = sh.seq_len if seq_len is None else seq_len
    shape = dataclasses.replace(sh, global_batch=B, seq_len=S)
    if depth is not None and shape.kind != "train":
        raise ValueError(f"--depth is an SPB suffix of a train step; "
                         f"{shape_name} is a {shape.kind} shape")
    depth = spb_depth(cfg, depth)
    params = lm.param_shapes(cfg)
    n = data_parallel
    if n > 1 and B % n:
        raise ValueError(f"--data-parallel {n} counts a step whose batch "
                         f"splits over the ranks ({shape_name}, batch {B})")
    group_rec: dict = {}
    t0 = time.time()
    if shape.kind == "train":
        tcfg = TrainConfig()
        group = DataGroup(rank=0, size=n, device=torch.device("meta"))
        shards = None
        if T > 1:
            shapes = steps_lib.train_state_shapes(whole, tcfg)
            mesh = sharding.Mesh((n, T), ("data", "model"))
            specs = {z: sharding.grid_state_pspec(shapes, mesh, zero1=z)
                     for z in (True, False)}
            key = sorted(shapes["opt"])[0]
            if zero1 and n > 1:
                shards = sharding.pipeline_opt_slices(
                    specs[True]["opt"][key],
                    steps_lib.train_state_shapes(cfg, tcfg)["opt"][key],
                    mesh, 0)
            group_rec = {"state_bytes": {
                "zero1": sharding.sharded_state_bytes(shapes, specs[True],
                                                      mesh),
                "replicated": sharding.sharded_state_bytes(
                    shapes, specs[False], mesh)}}
        elif n > 1:
            shapes = steps_lib.train_state_shapes(cfg, tcfg)
            mesh = sharding.mesh_for(group)
            specs = {z: sharding.state_pspec(shapes, mesh, zero1=z)
                     for z in (True, False)}
            if zero1:
                shards = sharding.opt_slices(shapes, specs[True], mesh, 0)
            group_rec = {"state_bytes": {
                "zero1": sharding.sharded_state_bytes(shapes, specs[True],
                                                      mesh),
                "replicated": sharding.sharded_state_bytes(
                    shapes, specs[False], mesh)}}
        state = steps_lib.state_from_params(
            tree_map(lambda t: t.requires_grad_(True), params), tcfg, shards)
        step = steps_lib.make_train_step(cfg, tcfg,
                                         SPBConfig(mode="temporal", k=4),
                                         depth=depth, remat=remat,
                                         group=group if n > 1 else None,
                                         shards=shards, model=model)
        _, s = cost.count(step, state, input_specs(
            cfg, dataclasses.replace(shape, global_batch=B // n)))
        if n > 1 or T > 1:
            ma = s.memory_analysis
            group_rec["predicted_peak_bytes"] = \
                ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
    else:
        enc_len = S if cfg.enc_layers else 0
        cache = lm.init_cache(cfg, B, S, enc_len=enc_len, device="meta")
        if n > 1 or T > 1:
            # one rank of the (n, T) serving grid: its rows, its heads and
            # FFN columns, its experts (dist/steps.shard_decode_step)
            kvcache.check_model_parallel(whole, T)
            mesh = sharding.Mesh((n, T), ("data", "model"))
            shapes = lm.param_shapes(whole)
            pspec = sharding.serve_params_pspec(shapes, whole, mesh)
            cspec = sharding.grid_cache_pspec(cache, whole, mesh)
            params = sharding.local_shapes(pspec, shapes, mesh)
            group_rec = {
                "param_bytes": sharding.sharded_state_bytes(shapes, pspec,
                                                            mesh),
                "cache_bytes": sharding.sharded_state_bytes(cache, cspec,
                                                            mesh)}
            cache = sharding.local_shapes(cspec, cache, mesh)
        local = dataclasses.replace(shape, global_batch=B // n)
        if shape.kind == "prefill":
            inputs = {k: v for k, v in input_specs(cfg, local).items()
                      if k != "labels"}
            _, s = cost.count(lm.prefill, params, inputs, cfg, cache,
                              tp=model)
        else:
            _, s = cost.count(lm.decode_step, params, cache,
                              decode_token_specs(cfg, local), cfg, tp=model)
    return {
        "arch": arch, "shape": shape_name, "mesh": roofline.MESH,
        "chips": 1, "depth": depth, "kind": shape.kind, "cut": cut,
        "remat": remat, "data_parallel": n, "zero1": zero1,
        "name": cfg.name, "layers": total_layers(cfg),
        "experts_held": cfg.moe.experts_held if cfg.moe else None,
        "batch": B, "seq_len": S,
        "use_pallas": cfg.use_pallas, "count_s": round(time.time() - t0, 2),
        **({"model_parallel": T} if T > 1 else {}),
        "flops_per_device": s.flops,
        "bytes_per_device": s.bytes,
        "collective_bytes_per_device": s.collective_bytes,
        "collective_breakdown": s.collective_breakdown,
        "num_collectives": s.num_collectives,
        "per_opcode_flops": {k: v for k, v in sorted(
            s.per_opcode_flops.items(), key=lambda kv: -kv[1])[:8]},
        "kernels": s.kernel_totals(),
        "kernel_shapes": s.kernels,
        "memory_analysis": s.memory_analysis,
        "saved_bytes": s.saved_bytes,
        **group_rec,
    }


def run_cell(arch: str, shape_name: str, *, cut: str = "published",
             depth: Optional[int] = None, batch: Optional[int] = None,
             seq_len: Optional[int] = None, force: bool = False,
             tag: str = "", out_dir: Optional[Path] = None,
             remat: str = "none", **kw) -> dict:
    """:func:`count_cell`, cached as JSON under ``out_dir`` (default
    ``roofline.RESULTS``); a failed count is recorded with ``ok`` False."""
    one_card(kw.get("multi_pod", False), kw.get("zero1", True),
             kw.get("rules_extra"))
    n = kw.get("data_parallel", 1)
    if n > 1:       # one rank of a group: a record of its own
        tag = f"{tag}dp{n}" + ("" if kw.get("zero1", True) else "-nozero1")
    if kw.get("model_parallel", 1) > 1:
        tag = f"{tag}mp{kw['model_parallel']}"
    if kw.get("layers") is not None:
        tag = f"{tag}L{kw['layers']}"
    # the recompute is a train step's: the other shapes run no backward
    remat = lm.resolve_remat(remat) if SHAPES[shape_name].kind == "train" \
        else "none"
    cfg = cut_config(arch, cut)
    if kw.get("layers") is not None:
        cfg = dataclasses.replace(cfg, num_layers=kw["layers"])
    depth = spb_depth(cfg, depth)
    path = roofline.cell_path(arch, shape_name, roofline.MESH, depth, tag,
                              cut=cut, batch=batch, seq_len=seq_len,
                              remat=remat)
    if out_dir is not None:
        path = Path(out_dir) / path.name
    if path.exists() and not force:
        return json.loads(path.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        rec = count_cell(arch, shape_name, cut=cut, depth=depth, batch=batch,
                         seq_len=seq_len, remat=remat, **kw)
        rec["ok"] = True
        rec["tag"] = tag
    except Exception as e:      # noqa: BLE001 -- recorded, as the reference's
        rec = {"arch": arch, "shape": shape_name, "mesh": roofline.MESH,
               "depth": depth, "cut": cut, "remat": remat, "ok": False,
               "error": str(e),
               "traceback": traceback.format_exc()[-4000:]}
    path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="every cell of the cell matrix")
    ap.add_argument("--depth", type=int, default=None,
                    help="SPB suffix depth (train shapes)")
    cut = ap.add_mutually_exclusive_group()
    cut.add_argument("--full-width", dest="cut", action="store_const",
                     const="full_width", help="the cut one card trains "
                     "(configs.full_width_config)")
    cut.add_argument("--reduced", dest="cut", action="store_const",
                     const="reduced")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="", help="variant tag for perf iters")
    ap.add_argument("--out", type=Path, default=None,
                    help="records directory (default results/dryrun_torch)")
    ap.add_argument("--remat", default="none", choices=lm.REMAT_POLICIES,
                    help="train steps' layer recompute (the reference's "
                         "values; its default is full, the port's none)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="count one rank of a data group of N (train)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="count one rank of a (data, model) grid with T "
                         "model ranks: MoE experts sharded over them "
                         "(impl='ep')")
    ap.add_argument("--no-zero1", action="store_true",
                    help="with --data-parallel: replicate the optimizer "
                         "state instead of sharding it")
    args = ap.parse_args(argv)
    cut_name = args.cut or "published"

    if args.all:
        todo = [(a, s) for a, s, _ in cells(include_skipped=True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]
    for arch, shape in todo:
        skip = shape_skip_reason(get_config(arch), SHAPES[shape])
        if skip:
            print(f"SKIP {arch} x {shape}: {skip}")
            continue
        depth = args.depth if SHAPES[shape].kind == "train" else None
        rec = run_cell(arch, shape, cut=cut_name, depth=depth,
                       batch=args.batch, seq_len=args.seq, force=args.force,
                       tag=args.tag, out_dir=args.out, remat=args.remat,
                       multi_pod=args.multi_pod, zero1=not args.no_zero1,
                       data_parallel=args.data_parallel,
                       layers=args.layers,
                       model_parallel=args.model_parallel)
        if rec.get("ok"):
            ma = rec.get("memory_analysis", {})
            print(f"OK  {arch:24s} {shape:12s} {rec['mesh']:5s} "
                  f"cut={rec['cut']} batch={rec['batch']}x{rec['seq_len']} "
                  f"depth={rec['depth']} remat={rec['remat']} "
                  f"count={rec['count_s']:.2f}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']:.3e} "
                  f"args={ma.get('argument_size_in_bytes', 0) / 2**30:.2f}GiB "
                  f"temp={ma.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB")
        else:
            print(f"ERR {arch:24s} {shape:12s} {rec['error'][:200]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
