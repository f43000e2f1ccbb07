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
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape long_500k \
      --pod [--multi-pod]       # one rank of a production mesh
  python -m repro_torch.launch.dryrun --all --pod   # every cell, both meshes

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
executables; the port's table is built on the card, ``engine/aot.py``).

The production meshes (``launch/mesh.make_production_mesh``): ``--pod``
counts one rank of the 16 x 16 ``(data, model)`` pod, ``--multi-pod`` one
rank of the ``(2, 16, 16)`` ``(pod, data, model)`` mesh, and ``--all
--pod`` every cell of ``configs.cells()`` on both, as the reference's
``--all`` does; the records say ``mesh`` ``pod16x16`` or ``pod2x16x16``
and ``chips`` 256 or 512.  A decode cell whose global batch is under 16
takes the reference's small-batch override ``{"batch": None, "kv_seq":
("data", "model")}`` (:data:`SMALL_BATCH_DECODE`; ``rules_extra`` merges
over it): every rank holds the batch and its 1/256th of the sequence, an
attn/local layer runs whole and the ranks' partial attentions are joined
by one all-gather a layer (``models/layers.seq_combine``), counted in the
collective bytes.  A prefill or decode cell counts the serving grid's
rank (``dist/steps.shard_decode_step``'s layout), a train cell the
``(data, model)`` grid's (``sharding.grid_state_pspec``, the experts over
``model`` and ZeRO-1 over ``("pod", "data")``).  A cell whose layout does
not divide under the reference's own rule table (``sharding.params_pspec``,
``cache_pspec``, ``state_pspec``: 4 KV heads over a 16-wide ``model`` axis,
say) writes ``ok: false`` with the error, as the reference's ``run_cell``
does where GSPMD refuses it.  An override that moves a role onto another
axis raises (``sharding.check_overrides``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Optional

from repro_torch.analysis import cost
from repro_torch.analysis import roofline
from repro_torch.config import (SHAPES, SPBConfig, TrainConfig, snap_depth,
                                total_layers)
from repro_torch.configs import (cells, cut_config, decode_token_specs,
                                 get_config, input_specs, shape_skip_reason)
import torch

from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup, ModelGroup, SeqGroup
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.serve import kvcache
from repro_torch.tree import tree_map


# the reference's small-batch decode override (``repro/launch/dryrun.py``'s
# ``lower_cell``): below 16 rows the batch cannot split over a pod's data
# axis, so it is held on every rank and the cache's sequence is sharded
SMALL_BATCH_DECODE = {"batch": None, "kv_seq": ("data", "model")}


def mesh_name(multi_pod: bool) -> str:
    """The reference's name of a production mesh's records."""
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_overrides(kind: str, global_batch: int, rules_extra=None):
    """A production cell's rule overrides: :data:`SMALL_BATCH_DECODE` for a
    decode shape of fewer than 16 rows, ``rules_extra`` merged over it."""
    over = dict(SMALL_BATCH_DECODE) \
        if kind == "decode" and global_batch < 16 else None
    if rules_extra:
        over = {**(over or {}), **rules_extra}
    return over


def spb_depth(cfg, depth: Optional[int]) -> Optional[int]:
    """``depth`` snapped as the engine snaps it; the full depth is None."""
    if depth is None:
        return None
    depth = snap_depth(cfg, depth)
    return None if depth == total_layers(cfg) else depth


def _reference_divides(cfg, shape, mesh, overrides, zero1: bool) -> None:
    """Raise ``ValueError`` where the reference's rule table does not lay
    the cell out on ``mesh`` under ``overrides``: its params (train: the
    state, ZeRO-1 or not), its cache, its batch (the refusals GSPMD makes
    when the reference's ``lower_cell`` places them)."""
    with sharding.rules(overrides):
        if shape.kind == "train":
            shapes = steps_lib.train_state_shapes(cfg, TrainConfig())
            sharding.check_divides(sharding.state_pspec(
                shapes, mesh, zero1=zero1), shapes, mesh, "state")
        else:
            shapes = lm.param_shapes(cfg)
            sharding.check_divides(sharding.params_pspec(shapes, mesh),
                                   shapes, mesh, "params")
            cache = lm.cache_shapes(cfg, shape.global_batch, shape.seq_len,
                                    enc_len=shape.seq_len if cfg.enc_layers
                                    else 0)
            sharding.check_divides(sharding.cache_pspec(cache, mesh), cache,
                                   mesh, "cache")
        rows = torch.empty((shape.global_batch, 1), device="meta")
        sharding.check_divides(sharding.batch_pspec(rows, mesh), rows, mesh,
                               "batch")


@dataclasses.dataclass
class CellLayout:
    """A cell's layout on its mesh (:func:`layout_cell`): the shape at the
    counted batch, the mesh and its overrides, its DP ranks ``n``, model
    ranks ``T``, the ranks its batch rows split over and its sequence
    shards, the kinds the serving grid holds whole, the config a rank runs
    (its held experts) and the one the layout reads (every expert); a
    prefill or decode cell's serving-grid specs of the params and cache
    (None on one card)."""
    shape: Any
    mesh: sharding.Mesh
    overrides: Optional[dict]
    production: bool
    n: int
    T: int
    rows_n: int
    n_seq: int
    whole_kinds: frozenset
    cfg: Any
    whole: Any
    pspec: Any = None
    cspec: Any = None


def layout_cell(arch: str, shape_name: str, *, cut: str = "published",
                batch: Optional[int] = None, seq_len: Optional[int] = None,
                pod: bool = False, multi_pod: bool = False,
                zero1: bool = True, rules_extra=None,
                data_parallel: int = 1, layers: Optional[int] = None,
                model_parallel: int = 1) -> CellLayout:
    """Lay one cell out as :func:`count_cell` counts it, raising where the
    layout does not divide: on a production mesh where the reference's
    rule table does not (:func:`_reference_divides`), and wherever the
    port's own grid layout does not (the batch rows, the serving grid's
    heads, FFN columns and experts: ``serve/kvcache.check_model_parallel``;
    the cache and params blocks).  Specs only: nothing is counted."""
    cfg = cut_config(arch, cut)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    sh = SHAPES[shape_name]
    B = sh.global_batch if batch is None else batch
    S = sh.seq_len if seq_len is None else seq_len
    shape = dataclasses.replace(sh, global_batch=B, seq_len=S)
    production = pod or multi_pod
    if production:
        if (data_parallel, model_parallel) != (1, 1):
            raise ValueError("--pod/--multi-pod count a rank of the "
                             "production mesh; --data-parallel and "
                             "--model-parallel name another grid")
        mesh = make_production_mesh(multi_pod=multi_pod)
        overrides = cell_overrides(shape.kind, B, rules_extra)
    else:
        mesh = sharding.Mesh((data_parallel, model_parallel),
                             ("data", "model"))
        overrides = rules_extra or None
    if overrides and shape.kind == "train":
        raise ValueError(f"rule overrides {overrides} lay out a prefill or "
                         f"decode cell; a train cell's grid takes none")
    sharding.check_overrides(overrides)
    n = math.prod(mesh.shape.get(a, 1) for a in sharding.DP_AXES)
    T = mesh.shape["model"]
    with sharding.rules(overrides):
        whole_kinds = sharding.grid_whole(mesh) if shape.kind != "train" \
            else frozenset()
        rows_n = sharding.batch_ranks(mesh)
        n_seq = math.prod(mesh.shape[a] for a in sharding.seq_axes(mesh))
    if production:
        _reference_divides(cfg, shape, mesh, overrides, zero1)
    whole = cfg                 # the grid's layout: every expert
    if T > 1 and cfg.moe is not None and "moe" not in whole_kinds:
        if cfg.moe.num_experts % T:
            raise ValueError(f"--model-parallel {T} does not divide the "
                             f"{cfg.moe.num_experts} experts of {arch}")
        whole = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep", experts_held=None))
        cfg = dataclasses.replace(whole, moe=dataclasses.replace(
            whole.moe, experts_held=cfg.moe.num_experts // T))
    if B % rows_n:
        raise ValueError(f"a batch of {B} rows ({shape_name}) does not "
                         f"split over {rows_n} data ranks")
    out = CellLayout(shape, mesh, overrides, production, n, T, rows_n,
                     n_seq, whole_kinds, cfg, whole)
    if shape.kind != "train" and (n > 1 or T > 1):
        if n_seq > 1 and shape.kind != "decode":
            raise ValueError(f"a kv_seq override shards a decode cache; "
                             f"{shape_name} is a {shape.kind} shape")
        kvcache.check_model_parallel(whole, T, whole_kinds)
        shapes = lm.param_shapes(whole)
        cache = lm.cache_shapes(whole, B, S, enc_len=S if cfg.enc_layers
                                else 0)
        with sharding.rules(overrides):
            out.pspec = sharding.serve_params_pspec(shapes, whole, mesh)
            out.cspec = sharding.grid_cache_pspec(cache, whole, mesh)
        sharding.local_shapes(out.pspec, shapes, mesh)
        sharding.local_shapes(out.cspec, cache, mesh)
    return out


def count_cell(arch: str, shape_name: str, *, cut: str = "published",
               depth: Optional[int] = None, batch: Optional[int] = None,
               seq_len: Optional[int] = None, pod: bool = False,
               multi_pod: bool = False, zero1: bool = True, rules_extra=None,
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
    FFN's columns too (the serving grid's layout).  ``pod`` or
    ``multi_pod`` count one rank of a production mesh instead (its DP
    ranks n, its T of 16), the cell's overrides :func:`cell_overrides`'s;
    elsewhere ``rules_extra`` alone.  A prefill or decode cell takes the
    overrides (the train step's grid has its own layout and takes none).
    The layout is :func:`layout_cell`'s, which raises where it does not
    divide."""
    remat = lm.resolve_remat(remat)
    if depth is not None and SHAPES[shape_name].kind != "train":
        raise ValueError(f"--depth is an SPB suffix of a train step; "
                         f"{shape_name} is a {SHAPES[shape_name].kind} "
                         f"shape")
    lay = layout_cell(arch, shape_name, cut=cut, batch=batch,
                      seq_len=seq_len, pod=pod, multi_pod=multi_pod,
                      zero1=zero1, rules_extra=rules_extra,
                      data_parallel=data_parallel, layers=layers,
                      model_parallel=model_parallel)
    shape, mesh, cfg, whole = lay.shape, lay.mesh, lay.cfg, lay.whole
    n, T, n_seq, whole_kinds = lay.n, lay.T, lay.n_seq, lay.whole_kinds
    B, S = shape.global_batch, shape.seq_len
    production, overrides = lay.production, lay.overrides
    model = ModelGroup(rank=0, size=T) if T > 1 else None
    depth = spb_depth(cfg, depth)
    params = lm.param_shapes(cfg)
    group_rec: dict = {}
    t0 = time.time()
    if shape.kind == "train":
        tcfg = TrainConfig()
        group = DataGroup(rank=0, size=n, device=torch.device("meta"))
        shards = None
        if T > 1:
            shapes = steps_lib.train_state_shapes(whole, tcfg)
            specs = {z: sharding.grid_state_pspec(shapes, mesh, zero1=z)
                     for z in (True, False)}
            key = sorted(shapes["opt"])[0]
            if zero1 and n > 1:
                shards = sharding.pipeline_opt_slices(
                    specs[True]["opt"][key],
                    steps_lib.train_state_shapes(cfg, tcfg)["opt"][key],
                    mesh, 0)
        elif n > 1:
            shapes = steps_lib.train_state_shapes(cfg, tcfg)
            specs = {z: sharding.state_pspec(shapes, mesh, zero1=z)
                     for z in (True, False)}
            if zero1:
                shards = sharding.opt_slices(shapes, specs[True], mesh, 0)
        if n > 1 or T > 1:
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
        seq = None
        if lay.pspec is not None:
            # one rank of the serving grid: its rows, its heads and FFN
            # columns, its experts, its share of the sequence
            # (dist/steps.shard_decode_step)
            shapes = lm.param_shapes(whole)
            params = sharding.local_shapes(lay.pspec, shapes, mesh)
            group_rec = {
                "param_bytes": sharding.sharded_state_bytes(
                    shapes, lay.pspec, mesh),
                "cache_bytes": sharding.sharded_state_bytes(
                    cache, lay.cspec, mesh)}
            cache = sharding.local_shapes(lay.cspec, cache, mesh)
            if n_seq > 1:
                seq = SeqGroup(rank=0, size=n_seq)
        local = dataclasses.replace(shape, global_batch=B // lay.rows_n)
        if shape.kind == "prefill":
            inputs = {k: v for k, v in input_specs(cfg, local).items()
                      if k != "labels"}
            _, s = cost.count(lm.prefill, params, inputs, cfg, cache,
                              tp=model)
        else:
            _, s = cost.count(lm.decode_step, params, cache,
                              decode_token_specs(cfg, local), cfg, tp=model,
                              seq=seq, whole=whole_kinds)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_name(multi_pod) if production else roofline.MESH,
        "chips": mesh.size if production else 1, "depth": depth,
        "kind": shape.kind, "cut": cut,
        "remat": remat, "data_parallel": n, "zero1": zero1,
        "name": cfg.name, "layers": total_layers(cfg),
        "experts_held": cfg.moe.experts_held if cfg.moe else None,
        "batch": B, "seq_len": S,
        "use_pallas": cfg.use_pallas, "count_s": round(time.time() - t0, 2),
        **({"model_parallel": T} if T > 1 else {}),
        **({"rules_overrides": overrides} if overrides else {}),
        **({"seq_shards": n_seq} if n_seq > 1 else {}),
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
    ``roofline.RESULTS``); a failed count is recorded with ``ok`` False
    and its error, as the reference's ``run_cell`` records a cell GSPMD
    refuses.  A production mesh's record is named by its mesh
    (:func:`mesh_name`)."""
    production = kw.get("pod", False) or kw.get("multi_pod", False)
    mesh = mesh_name(kw.get("multi_pod", False)) if production \
        else roofline.MESH
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
    path = roofline.cell_path(arch, shape_name, mesh, depth, tag,
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
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
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
    ap.add_argument("--pod", action="store_true",
                    help="count one rank of the 16 x 16 production pod "
                         "(launch/mesh.make_production_mesh); with --all, "
                         "every cell on the pod and the multi-pod mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="count one rank of the (2, 16, 16) multi-pod mesh")
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
        meshes = [(True, False), (False, True)] if args.pod else \
            [(False, args.multi_pod)]
        todo = [(a, s, p, m) for a, s, _ in cells(include_skipped=True)
                for p, m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape, args.pod, args.multi_pod)]
    for arch, shape, pod, multi in todo:
        skip = shape_skip_reason(get_config(arch), SHAPES[shape])
        if skip:
            print(f"SKIP {arch} x {shape}: {skip}")
            continue
        depth = args.depth if SHAPES[shape].kind == "train" else None
        rec = run_cell(arch, shape, cut=cut_name, depth=depth,
                       batch=args.batch, seq_len=args.seq, force=args.force,
                       tag=args.tag, out_dir=args.out, remat=args.remat,
                       pod=pod, multi_pod=multi, zero1=not args.no_zero1,
                       data_parallel=args.data_parallel,
                       layers=args.layers,
                       model_parallel=args.model_parallel)
        if rec.get("ok"):
            ma = rec.get("memory_analysis", {})
            print(f"OK  {arch:24s} {shape:12s} {rec['mesh']:10s} "
                  f"cut={rec['cut']} batch={rec['batch']}x{rec['seq_len']} "
                  f"depth={rec['depth']} remat={rec['remat']} "
                  f"count={rec['count_s']:.2f}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']:.3e} "
                  f"args={ma.get('argument_size_in_bytes', 0) / 2**30:.2f}GiB "
                  f"temp={ma.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB")
        else:
            print(f"ERR {arch:24s} {shape:12s} {rec['mesh']:10s} "
                  f"{rec['error'][:200]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
