"""Three-term roofline of one NVIDIA H100 from the dry-run records, plus
the analytic MODEL_FLOPS (the counterpart of ``repro/analysis/roofline.py``).

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = wire_bytes_per_device / LINK_BW

flops and bytes come from the counted step (``analysis/cost.py``, written
by ``launch/dryrun.py``).  MODEL_FLOPS is the analytic useful-work
yardstick: 6*N*D for training (N = active non-embedding params, D =
tokens) plus exact attention-window terms; 2*N*D for inference forward
passes.  The ratio MODEL_FLOPS / counted FLOPs exposes recompute and
redundancy per cell.  The constants are NVIDIA's data-sheet peaks of the
SXM part at its 700 W limit (dense, no sparsity).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.config import (SHAPES, ModelConfig, ShapeConfig,
                                layer_kinds, total_layers)

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FLOPS_F32 = 67e12       # f32 outside the tensor cores
HBM_BW = 3.35e12             # B/s
LINK_BW = 450e9              # B/s, NVLink 4 per direction
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": PEAK_FLOPS_F32}
MESH = "h100"

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


# ---------------------------------------------------------------------------
# Analytic parameter / FLOP counting
# ---------------------------------------------------------------------------

def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """Total/active/embedding parameter counts from the param shapes.  A
    routed expert leaf is active at top_k / num_experts; with a held share
    of the experts (``experts_held``) that fraction of the held ones."""
    from repro_torch.models import lm
    total = active = embed = 0.0
    moe_frac = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    held = (cfg.moe.experts_held or cfg.moe.num_experts) if cfg.moe else 0
    for names, leaf in _leaves_with_path(lm.param_shapes(cfg)):
        n = 1.0
        for d in leaf.shape:
            n *= d
        total += n
        if "embed" in names:
            embed += n
            continue
        if ("ffn" in names and len(leaf.shape) >= 3 and cfg.moe
                and leaf.shape[-3] == held):
            active += n * moe_frac          # routed experts: top_k/E active
        else:
            active += n
    return {"total": total, "active": active, "embed": embed,
            "nonembed": total - embed}


def _attention_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Forward attention-score+value FLOPs per token at context ctx
    (averaged causal 1/2 factor; window layers use min(ctx, window))."""
    fl = 0.0
    for mixer, _ in layer_kinds(cfg):
        if mixer in ("attn", "xdec"):
            span = ctx / 2
        elif mixer == "local":
            span = min(ctx / 2, cfg.window)
        elif mixer == "mla":
            span = ctx / 2
        else:
            continue                        # ssd/rglru: linear, in params
        if cfg.mla is not None and mixer == "mla":
            h, dqk, dv = cfg.num_heads, (cfg.mla.qk_nope_head_dim +
                                         cfg.mla.qk_rope_head_dim), cfg.mla.v_head_dim
        else:
            h, dqk, dv = cfg.num_heads, cfg.head_dim, cfg.head_dim
        fl += 2 * span * h * (dqk + dv)
    return fl


def model_flops(cfg: ModelConfig, shape: ShapeConfig,
                bwd_fraction: float = 1.0) -> float:
    """Global useful FLOPs for one step of this cell.

    train: (2 + 4*bwd_fraction) * N_active * tokens + attention terms
    prefill: 2 * N_active * tokens + attention
    decode: 2 * N_active * batch + attention over the cache
    """
    n = count_params(cfg)["nonembed"]
    if cfg.moe:
        n = count_params(cfg)["active"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        factor = 2 + 4 * bwd_fraction
        attn = _attention_flops_per_token(cfg, S) * tokens * (
            1 + 2 * bwd_fraction)
        return factor * n * tokens + attn
    if shape.kind == "prefill":
        tokens = B * S
        return 2 * n * tokens + _attention_flops_per_token(cfg, S) * tokens
    # decode: one token per sequence, attention over full cache
    attn_tok = 0.0
    for mixer, _ in layer_kinds(cfg):
        if mixer in ("attn", "xdec", "mla"):
            span = S
        elif mixer == "local":
            span = min(S, cfg.window)
        else:
            continue
        if cfg.mla is not None and mixer == "mla":
            # absorbed decode: scores/values in latent space of rank r
            span_cost = 2 * span * cfg.num_heads * (
                cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
                + cfg.mla.kv_lora_rank)
        else:
            span_cost = 2 * span * cfg.num_heads * 2 * cfg.head_dim
        attn_tok += span_cost
    return 2 * n * B + attn_tok * B


# ---------------------------------------------------------------------------
# Decode-phase serving roofline (bandwidth-bound tokens/s ceiling)
# ---------------------------------------------------------------------------

def _elem_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype in ("bfloat16", "float16") else 4


def decode_kv_bytes(cfg: ModelConfig, context: int) -> float:
    """Bytes of KV cache ONE slot streams per decode step at ``context``.

    attn layers read the full context, local layers at most the window,
    MLA layers the latent (ckv + rope-k) rows; recurrent mixers carry
    O(1) state and are negligible here."""
    elem = _elem_bytes(cfg)
    total = 0.0
    for mixer, _ in layer_kinds(cfg):
        if mixer == "mla":
            total += context * (cfg.mla.kv_lora_rank
                                + cfg.mla.qk_rope_head_dim) * elem
            continue
        if mixer in ("attn", "xdec"):
            span = context
        elif mixer == "local":
            span = min(context, cfg.window)
        else:
            continue
        total += span * 2 * cfg.num_kv_heads * cfg.head_dim * elem
    return total


def decode_bandwidth_bound(cfg: ModelConfig, batch: int, context: int, *,
                           bw: float = HBM_BW) -> float:
    """Bandwidth-bound decode throughput ceiling in tokens/s.

    Each decode step streams the (active) weights once -- amortized over
    the whole batch, which is why continuous batching pays -- plus every
    slot's KV context:

        tokens/s <= batch * BW / (weight_bytes + batch * kv_bytes(ctx))

    The weight term uses active params (MoE: top_k/E of the experts)
    plus the embedding/unembedding matrix, all in the model dtype.
    """
    counts = count_params(cfg)
    wbytes = (counts["active"] + counts["embed"]) * _elem_bytes(cfg)
    kv = decode_kv_bytes(cfg, context)
    return batch * bw / (wbytes + batch * kv)


# ---------------------------------------------------------------------------
# Pipeline-parallel terms (schedule-table driven)
# ---------------------------------------------------------------------------

def pipeline_bubble_fraction(num_stages: int, num_microbatches: int, *,
                             kind: str = "1f1b",
                             bwd_stages: Optional[int] = None,
                             bwd_cost: float = 2.0) -> float:
    """Idle fraction of a pipeline schedule, measured on its work table
    (``dist/pipeline/schedules``): idle device-time slots, backward ticks
    weighted by ``bwd_cost``."""
    from repro_torch.dist.pipeline import schedules
    sched = schedules.build(kind, num_stages, num_microbatches,
                            bwd_stages=bwd_stages)
    return schedules.bubble_fraction_of(sched, bwd_cost=bwd_cost)


def pipeline_step_time(step_s: float, num_stages: int,
                       num_microbatches: int, *, kind: str = "1f1b",
                       bwd_stages: Optional[int] = None,
                       bwd_cost: float = 2.0) -> float:
    """Roofline step time under pipeline parallelism: the per-stage share
    of the non-pipelined step, inflated by the schedule's bubble."""
    bubble = pipeline_bubble_fraction(num_stages, num_microbatches,
                                      kind=kind, bwd_stages=bwd_stages,
                                      bwd_cost=bwd_cost)
    return (step_s / num_stages) / max(1.0 - bubble, 1e-9)


def pipeline_stash_watermark(num_stages: int, num_microbatches: int, *,
                             kind: str = "1f1b",
                             bwd_stages: Optional[int] = None,
                             sched=None) -> Tuple[int, int]:
    """(activation, cotangent) stash slots the schedule's runtime
    allocates: the per-stage memory watermark from the table's
    ``stash_plan``.  Pass an already-built ``sched`` to measure exactly it
    instead of rebuilding from ``(kind, bwd_stages)``."""
    from repro_torch.dist.pipeline import schedules
    if sched is None:
        sched = schedules.build(kind, num_stages, num_microbatches,
                                bwd_stages=bwd_stages)
    elif (sched.num_stages, sched.num_microbatches) != \
            (num_stages, num_microbatches):
        raise ValueError(
            f"sched is {sched.num_stages}x{sched.num_microbatches} but the "
            f"arguments claim {num_stages}x{num_microbatches}")
    plan = schedules.stash_plan(sched)
    return plan.act_slots, plan.cot_slots


def pipeline_stash_bytes(cfg: ModelConfig, microbatch: int, seq_len: int,
                         num_stages: int, num_microbatches: int, *,
                         kind: str = "1f1b",
                         bwd_stages: Optional[int] = None,
                         data_parallel: int = 1, sched=None) -> int:
    """Bytes of activation+cotangent stash per device for one schedule;
    each boundary activation is ``(microbatch / data_parallel, seq,
    d_model)`` in the model dtype."""
    act, cot = pipeline_stash_watermark(num_stages, num_microbatches,
                                        kind=kind, bwd_stages=bwd_stages,
                                        sched=sched)
    if data_parallel < 1 or microbatch % data_parallel:
        raise ValueError(f"microbatch size {microbatch} not divisible by "
                         f"data_parallel={data_parallel}")
    elem = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    per_slot = (microbatch // data_parallel) * seq_len * cfg.d_model * elem
    return (act + cot) * per_slot


def pipeline_tp_collective_bytes(cfg: ModelConfig, microbatch: int,
                                 seq_len: int, num_stages: int,
                                 num_microbatches: int, *,
                                 model_parallel: int,
                                 data_parallel: int = 1,
                                 bwd_stages: Optional[int] = None,
                                 sequence_parallel: bool = False) -> float:
    """Per-device wire bytes of the in-stage tensor-parallel collectives
    for one pipeline step: two joins a transformer layer, each one
    residual-stream activation ``(mb/dp, seq, d_model)`` on a ring
    (``2(n-1)/n`` of it), mirrored by the backward of the stages SPB keeps
    live; sequence parallelism adds an outlet gather a microbatch (and
    its mirror)."""
    n = int(model_parallel)
    if n <= 1:
        return 0.0
    if data_parallel < 1 or microbatch % data_parallel:
        raise ValueError(f"microbatch size {microbatch} not divisible by "
                         f"data_parallel={data_parallel}")
    elem = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    act = (microbatch // data_parallel) * seq_len * cfg.d_model * elem
    try:
        from repro_torch.config import stage_layer_counts
        # heterogeneous stage maps: the busiest stage bounds the wire
        layers_per_stage = max(1, max(stage_layer_counts(cfg, num_stages)))
    except (ValueError, ImportError):
        layers_per_stage = max(1, cfg.num_layers // max(num_stages, 1))
    bwd = num_stages if bwd_stages is None else max(0, min(bwd_stages,
                                                           num_stages))
    wire_join = 2.0 * (n - 1) / n * act
    joins = 2 * layers_per_stage * num_microbatches
    fwd_total = joins * wire_join
    bwd_total = joins * wire_join * (bwd / max(num_stages, 1))
    total = fwd_total + bwd_total
    if sequence_parallel:
        edge = (n - 1) / n * act
        total += num_microbatches * edge                      # outlet gather
        total += num_microbatches * edge * (bwd / max(num_stages, 1))
    return total


def pipeline_tp_calls(cfg: ModelConfig, stage_layers: int,
                      num_microbatches: int, rows: int, seq_len: int, *,
                      model_parallel: int, live: bool,
                      need_dx: bool = True,
                      sequence_parallel: bool = False,
                      update: bool = True) -> Dict[str, Tuple[int, int]]:
    """What one pipeline step calls on one rank's model group
    (``dist/group.ModelGroup``), ``{kind: (calls, payload bytes)}``: a
    stage of ``stage_layers`` dense layers, ``num_microbatches``
    microbatches of ``rows`` rows (this data rank's) by ``seq_len``.

    The port's own count, not the reference's: every microbatch's forward
    runs on its forward tick (under ``no_grad``) and again on a live
    stage's backward tick, which recomputes it before its backward, so a
    live stage calls its forward joins twice where
    :func:`pipeline_tp_collective_bytes` counts them once (and prices the
    wire on a ring, where this counts each call's payload: an all-reduce's
    and a reduce-scatter's input, an all-gather's output).  Without
    sequence parallelism a layer all-reduces its two joins (``tp_psum``)
    and, in the backward, its two entries' cotangents (``tp_enter``).
    With it, a layer all-gathers its two entries and reduce-scatters its
    two joins, the stage's outlet gathers the sequence (``sp_unslice``),
    the backward mirrors each (the inlet's ``sp_slice`` gathers the input
    cotangent when ``need_dx``), and after the schedule each norm scale's
    gradient is all-reduced once (two stacked leaves, ``ln1`` and
    ``ln2``).  A step that updates (``update``) all-reduces its
    model-sharded leaves' f32 sum of squares once, for the gradient norm,
    on every rank.  The count is the recompute policy ``none``'s: under
    ``full`` or ``dots`` a live layer also runs its entries and its
    attention join again in its backward (torch's checkpoint stops the
    recompute at the FFN's down product, the last tensor the backward
    keeps)."""
    t = int(model_parallel)
    if t <= 1:
        return {}
    elem = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    act = rows * seq_len * cfg.d_model * elem
    passes = 2 if live else 1          # the forward tick, the recompute
    L, M = stage_layers, num_microbatches
    norm = (1, 4) if update else (0, 0)
    if not sequence_parallel:
        n = M * (2 * L * passes + (2 * L if live else 0))
        return {"all-reduce": (n + norm[0], n * act + norm[1])}
    ag = M * (passes * (2 * L + 1)
              + ((2 * L + (1 if need_dx else 0)) if live else 0))
    rs = M * (passes * 2 * L + (2 * L if live else 0))
    out = {"all-gather": (ag, ag * act), "reduce-scatter": (rs, rs * act)}
    ar = (2, 2 * L * cfg.d_model * elem) if live else (0, 0)
    if ar[0] + norm[0]:
        out["all-reduce"] = (ar[0] + norm[0], ar[1] + norm[1])
    return out


def moe_layers_live(cfg: ModelConfig, depth: Optional[int]
                    ) -> Tuple[int, int]:
    """(live, frozen) MoE layers of the decoder at SPB suffix ``depth``
    (None: every layer live)."""
    total = total_layers(cfg)
    boundary = total - (total if depth is None else depth)
    live = frozen = 0
    for i, (_mixer, ffn) in enumerate(layer_kinds(cfg)):
        if ffn == "moe":
            if cfg.enc_layers + i >= boundary:
                live += 1
            else:
                frozen += 1
    return live, frozen


def _ep_layer_calls(cfg: ModelConfig, n_tok: int, t: int, layers: int,
                    live: int, add: Callable[[str, int, int], None]) -> None:
    """``moe_fwd_ep``'s calls in ``layers`` MoE layers' forwards over
    ``n_tok`` tokens, and in the backwards of ``live`` of them
    (:func:`ep_calls`)."""
    m = cfg.moe
    elem = 2 if cfg.dtype in ("bfloat16", "float16") else 4
    act = n_tok * cfg.d_model * elem
    if n_tok < 4 * t:
        add("all-reduce", layers + live, act)
        add("all-reduce", layers, 4)
    else:
        from repro_torch.models.moe import capacity
        c = capacity(n_tok // t * m.top_k, m.num_experts, m.capacity_factor)
        add("all-to-all", 2 * layers + 2 * live,
            m.num_experts * c * cfg.d_model * elem)
        add("all-gather", layers + live, act)
        add("all-reduce", layers, 4)


def serve_tp_calls(cfg: ModelConfig, model_parallel: int, rows: int,
                   seq_len: int, *, seq_shards: int = 1,
                   whole: frozenset = frozenset()
                   ) -> Dict[str, Tuple[int, int]]:
    """What one model rank of the serving grid calls on its model group
    (``dist/group.ModelGroup``) in one prefill or one decode step of
    ``rows`` rows by ``seq_len`` positions (``lm.prefill``,
    ``decode_step``, ``serve_prefill``, ``serve_decode`` with ``tp=``),
    ``{kind: (calls, payload bytes)}``: each attn/local layer all-reduces
    its ``wo`` join once and each dense FFN its ``wd`` join, a payload of
    ``rows x seq_len x d_model x itemsize``; a MoE layer under
    ``impl="dense"`` all-reduces its experts' partial outputs once (the
    same payload), under ``impl="ep"`` calls what ``moe_fwd_ep``'s forward
    does (:func:`ep_calls`); an MLA, SSD, RG-LRU or ``xdec`` mixer runs
    whole and calls nothing, as do the kinds of ``whole``
    (``dist/sharding.grid_whole``: ``"attn"``, ``"ffn"``, ``"moe"``).  A
    serve prefill runs the whole bucket: ``rows`` 1, ``seq_len`` the
    bucket.

    ``seq_shards`` n > 1: a decode step over a cache whose sequence is
    sharded n ways (a ``kv_seq`` override).  Then the key ``"combine"``
    holds the calls of the ``dist/group.SeqGroup``, another group of n
    ranks: each attn/local/MLA layer all-gathers its packed partial
    attention once (an ``xdec`` layer twice, self and cross), a payload of
    ``n x rows x H x (Dv + 2) x 4`` (f32; Dv is ``head_dim``, an MLA's
    ``kv_lora_rank``).  :func:`serve_wire_bytes` totals the wire bytes."""
    t = int(model_parallel)
    calls: Dict[str, List[int]] = {}

    def add(kind: str, count: int, nbytes: int) -> None:
        if count:
            c = calls.setdefault(kind, [0, 0])
            c[0] += count
            c[1] += count * nbytes

    kinds = layer_kinds(cfg)
    n = int(seq_shards)
    if n > 1:
        H = cfg.num_heads
        for mixer, _ in kinds:
            if mixer in ("attn", "local", "xdec"):
                add("combine", 2 if mixer == "xdec" else 1,
                    n * rows * H * (cfg.head_dim + 2) * 4)
            elif mixer == "mla":
                add("combine", 1, n * rows * H * (cfg.mla.kv_lora_rank + 2)
                    * 4)
    if t > 1:
        elem = 2 if cfg.dtype in ("bfloat16", "float16") else 4
        n_tok = rows * seq_len
        act = n_tok * cfg.d_model * elem
        ffn = [f for _, f in kinds] if cfg.d_ff > 0 else []
        add("all-reduce",
            (0 if "attn" in whole else
             sum(m in ("attn", "local") for m, _ in kinds))
            + (0 if "ffn" in whole else ffn.count("dense")), act)
        moe = 0 if "moe" in whole else ffn.count("moe")
        if moe and cfg.moe.impl == "dense":
            add("all-reduce", moe, act)
        elif moe:
            _ep_layer_calls(cfg, n_tok, t, moe, 0, add)
    return {k: (v[0], v[1]) for k, v in calls.items()}


def serve_wire_bytes(calls: Dict[str, Tuple[int, int]], model_parallel: int,
                     seq_shards: int = 1) -> Dict[str, float]:
    """The wire bytes a rank sends, by collective kind, for
    :func:`serve_tp_calls`'s ``calls`` (``analysis/cost.wire_bytes``'s ring
    model): the model group's over ``model_parallel`` ranks, the
    ``"combine"`` gathers over ``seq_shards``."""
    from repro_torch.analysis.cost import wire_bytes
    out: Dict[str, float] = {}
    for kind, (_, nbytes) in calls.items():
        k, n = ("all-gather", seq_shards) if kind == "combine" \
            else (kind, model_parallel)
        out[k] = out.get(k, 0.0) + wire_bytes(k, n, nbytes)
    return out


def ep_calls(cfg: ModelConfig, rows: int, seq_len: int, *,
             model_parallel: int, depth: Optional[int]
             ) -> Dict[str, Tuple[int, int]]:
    """What one temporal step calls on a ``(data, model)`` grid rank's
    model group (``dist/group.ModelGroup``), ``{kind: (calls, payload
    bytes)}``: ``rows`` rows of this data index by ``seq_len``, at SPB
    suffix ``depth``, the recompute policy 'none'.

    Each MoE layer's forward (frozen or live) exchanges its dispatch and
    its outputs (two all-to-alls of the ``(T, E/T, C, D)`` slot buffer,
    ``E C D`` elements, ``C`` the capacity of ``N k / T`` routed slots),
    all-gathers the tokens' outputs (``N D``, the result's bytes) and
    all-reduces its aux (4 B); a live layer's backward exchanges twice
    more and all-gathers the input's cotangent (``N D``).  With fewer than
    ``4 T`` tokens a layer takes the small path instead: an all-reduce of
    the partial outputs (``N D``) and of the aux forward, of the input's
    cotangent in a live layer's backward.  The step then sums
    the live layers' router and shared-expert gradients in one f32
    all-reduce, and all-reduces the experts' f32 sum of squares for the
    clip norm (4 B)."""
    t = int(model_parallel)
    if t <= 1 or cfg.moe is None:
        return {}
    m = cfg.moe
    live, frozen = moe_layers_live(cfg, depth)
    n_tok = rows * seq_len
    calls: Dict[str, List[int]] = {}

    def add(kind: str, count: int, nbytes: int) -> None:
        if count:
            c = calls.setdefault(kind, [0, 0])
            c[0] += count
            c[1] += count * nbytes

    _ep_layer_calls(cfg, n_tok, t, live + frozen, live, add)
    if live:
        shared = 3 * cfg.d_model * m.num_shared * m.d_ff_expert
        add("all-reduce", 1,
            4 * live * (cfg.d_model * m.num_experts + shared))
    add("all-reduce", 1, 4)
    return {k: (v[0], v[1]) for k, v in calls.items()}


# ---------------------------------------------------------------------------
# Roofline table
# ---------------------------------------------------------------------------

@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float       # the counted FLOPs, times the chips
    useful_ratio: float
    step_s: float                 # max of the three terms
    mfu: float                    # model_flops / (chips * peak * step_s)
    temp_gib: float

    @property
    def bound(self) -> str:
        return self.dominant


def cell_path(arch: str, shape: str, mesh: str = MESH, depth=None,
              tag: str = "", *, cut: str = "published",
              batch: Optional[int] = None,
              seq_len: Optional[int] = None, remat: str = "none") -> Path:
    """A record's file: the reference's ``arch__shape__mesh[__dD][__tag]``
    with the config's cut and any batch other than the shape's after the
    mesh (one card runs a cut of the published depth at its own batch),
    and a layer-recompute policy other than 'none' after the depth (the
    reference's files do not tell policies apart)."""
    sh = SHAPES[shape]
    v = "" if cut == "published" else f"__{cut}"
    if (batch, seq_len) != (None, None) and \
            (batch, seq_len) != (sh.global_batch, sh.seq_len):
        v += f"__b{batch}x{seq_len}"
    d = f"__d{depth}" if depth is not None else ""
    if remat != "none":
        d += f"__remat-{remat}"
    t = f"__{tag}" if tag else ""
    return RESULTS / f"{arch}__{shape}__{mesh}{v}{d}{t}.json"


def load_record(arch: str, shape: str, mesh: str = MESH, depth=None,
                tag: str = "", **variant) -> Optional[dict]:
    p = cell_path(arch, shape, mesh, depth, tag, **variant)
    if not p.exists():
        return None
    rec = json.loads(p.read_text())
    return rec if rec.get("ok") else None


def records(results_dir: Optional[Path] = None) -> List[dict]:
    """Every ok record of the directory (default :data:`RESULTS`)."""
    d = RESULTS if results_dir is None else Path(results_dir)
    out = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    return [r for r in out if r.get("ok")]


def record_shape(rec: dict) -> ShapeConfig:
    """The record's shape at the batch it was counted at."""
    sh = SHAPES[rec["shape"]]
    return dataclasses.replace(sh, global_batch=rec.get("batch",
                                                        sh.global_batch),
                               seq_len=rec.get("seq_len", sh.seq_len))


def record_config(rec: dict) -> ModelConfig:
    """The config the record was counted at (its ``cut``)."""
    from repro_torch.configs import cut_config
    return cut_config(rec["arch"], rec.get("cut", "published"))


def roofline_row(rec: dict, cfg: ModelConfig) -> RooflineRow:
    """The record's three terms and MFU.  A train record at SPB depth d
    of L layers counts model FLOPs at ``bwd_fraction`` d / L."""
    shape = record_shape(rec)
    chips = rec["chips"]
    comp = rec["flops_per_device"] / PEAK_FLOPS
    mem = rec["bytes_per_device"] / HBM_BW
    coll = rec["collective_bytes_per_device"] / LINK_BW
    terms = {"compute": comp, "memory": mem, "collective": coll}
    dominant = max(terms, key=terms.get)
    frac = 1.0
    if shape.kind == "train" and rec.get("depth") is not None:
        frac = rec["depth"] / total_layers(cfg)
    mf = model_flops(cfg, shape, bwd_fraction=frac)
    hlo_global = rec["flops_per_device"] * chips
    step = max(terms.values())
    mfu = mf / (chips * PEAK_FLOPS * step) if step > 0 else 0.0
    temp = rec.get("memory_analysis", {}).get("temp_size_in_bytes", 0) / 2 ** 30
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=comp, memory_s=mem, collective_s=coll, dominant=dominant,
        model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        step_s=step, mfu=mfu, temp_gib=temp)


def full_table(mesh: str = MESH) -> List[RooflineRow]:
    """A row for every ok full-backprop record of ``mesh``, each at the
    config it was counted at."""
    return [roofline_row(r, record_config(r)) for r in records()
            if r.get("mesh") == mesh and r.get("depth") is None]


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'chips':>5s} {'compute':>9s} "
           f"{'memory':>9s} {'collectv':>9s} {'bound':>10s} {'MFU':>6s} "
           f"{'useful':>7s} {'temp':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.chips:5d} {r.compute_s:9.4f} "
            f"{r.memory_s:9.4f} {r.collective_s:9.4f} {r.dominant:>10s} "
            f"{r.mfu:6.1%} {r.useful_ratio:7.2f} {r.temp_gib:7.2f}G")
    return "\n".join(lines)


if __name__ == "__main__":
    print(format_table(full_table()))
