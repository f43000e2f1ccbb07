"""Stage partitioning: map an ``models/lm.py`` stack onto pipeline stages
(the counterpart of ``repro/dist/pipeline/stage.py``).

The decoder stack is stored stacked (one ``(count, ...)`` leaf per
parameter of a group's repeating unit), so a stage is a contiguous slice
of rows of each group.  :func:`build_stage_map` cuts the stack into
``S`` slices of whole units (``config.stage_unit_cuts``);
:func:`stack_stage_params` and :func:`unstack_stage_grads` are the
reference's stage-stacked layout, ``(S, rows, ...)`` leaves, kept for
parity and for the one-process oracle.

A stage of the port is a rank (``dist/group.PipeGroup``), and a rank
holds only what its stage runs (:func:`local_tree`): its rows of every
group (zero rows of a group it does not touch), the token table on the
first stage, and the final norm (and an untied unembedding) on the last.
Where the embeddings are tied, the last stage keeps a copy of the table
outside its state for the head, refreshed from the first stage after
each update (``dist/steps.make_pipeline_train_step``).  The reference
replicates the embedding and the head over every stage instead.

Every stage fn returns ``(x, aux)`` (:func:`make_stage_fns`), so an MoE
layer's router loss rides the schedule runtime's aux channel.

Tensor-parallel stages (a ``model`` axis of T ranks,
``dist/group.ModelGroup``): a rank also holds only its model shard of each
column- or row-sharded group leaf (``wq``, ``wk``, ``wv``, ``wg``, ``wu``
on their last dim, ``wo``, ``wd`` on the one before;
:func:`model_shard_dim`, the rule :func:`stage_param_specs` composes after
the stage axis), and the stage fns join the layers' partial sums over the
group (``models/layers.py``'s collective pairs).  Every other leaf -- the
norms, the token table, the head -- is whole on each model rank: the
reference's shard_map also sees the head's parameters replicated.  Under
sequence parallelism a stage slices its input over the sequence at the
inlet (``sp_slice``) and gathers it at the outlet (``sp_unslice``), so
what crosses to the next stage is whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.config import (ModelConfig, layer_groups, stage_unit_cuts,
                                total_layers)
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.tree import tree_map, tree_map_with_path

# ---------------------------------------------------------------------------
# Stage maps: contiguous slices of possibly-heterogeneous layer groups
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageMap:
    """How the layer groups partition into pipeline stages.

    ``segments[s]`` lists stage ``s``'s ``(group, unit_start,
    unit_count)`` slices, at most one a group, in stack order.
    ``caps[g]`` is the widest slice any stage takes from group ``g``: the
    stage-stacked leaf of that group is ``(S, caps[g], ...)``, each
    stage's rows at ``[0:count]`` and zero rows beyond."""
    num_stages: int
    segments: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    caps: Tuple[int, ...]

    @property
    def trivial(self) -> bool:
        """One group, evenly split: the plain reshape partition."""
        return len(self.caps) == 1 and self.uniform[0]

    @property
    def uniform(self) -> Tuple[bool, ...]:
        """Per group: does every stage take exactly ``count / S`` units (so
        the stage-stacked leaf is a pure reshape)?"""
        out = []
        for g, cap in enumerate(self.caps):
            segs = [seg for stage in self.segments for seg in stage
                    if seg[0] == g]
            total = sum(cnt for _g, _st, cnt in segs)
            out.append(len(segs) == self.num_stages
                       and all(cnt == cap for _g, _st, cnt in segs)
                       and total == cap * self.num_stages)
        return tuple(out)

    def rows(self, stage: int) -> Tuple[Tuple[int, int], ...]:
        """Per group: ``(first unit, unit count)`` of ``stage``'s slice,
        ``(0, 0)`` for a group it does not touch."""
        out = [(0, 0)] * len(self.caps)
        for g, start, cnt in self.segments[stage]:
            out[g] = (start, cnt)
        return tuple(out)


def build_stage_map(cfg: ModelConfig, num_stages: int) -> StageMap:
    """Balanced contiguous partition of the decoder stack into stages
    (cuts from ``config.stage_unit_cuts``: whole units only, layer counts
    balanced)."""
    if cfg.enc_layers:
        raise ValueError(f"{cfg.name}: encoder-decoder stacks are not "
                         "pipeline-partitionable")
    groups = layer_groups(cfg)
    owners: List[Tuple[int, int]] = []
    for g, (_unit, count) in enumerate(groups):
        owners.extend((g, i) for i in range(count))
    cuts = stage_unit_cuts(cfg, num_stages)
    segments = []
    for a, b in zip(cuts, cuts[1:]):
        segs: List[Tuple[int, int, int]] = []
        for g, i in owners[a:b]:
            if segs and segs[-1][0] == g:
                segs[-1] = (g, segs[-1][1], segs[-1][2] + 1)
            else:
                segs.append((g, i, 1))
        segments.append(tuple(segs))
    caps = tuple(max((cnt for stage in segments
                      for gg, _st, cnt in stage if gg == g), default=0)
                 for g in range(len(groups)))
    return StageMap(num_stages=num_stages, segments=tuple(segments),
                    caps=caps)


def render_stage_map(cfg: ModelConfig, num_stages: int) -> str:
    """Human-readable stage table."""
    smap = build_stage_map(cfg, num_stages)
    groups = layer_groups(cfg)
    lines = []
    for s, segs in enumerate(smap.segments):
        parts, nl = [], 0
        for g, start, cnt in segs:
            unit, _count = groups[g]
            nl += cnt * len(unit)
            kinds = "+".join(m for m, _f in unit)
            parts.append(f"g{g}[{start}:{start + cnt}]x{len(unit)}({kinds})")
        lines.append(f"stage {s}: {' '.join(parts)}  [{nl} layers]")
    return "\n".join(lines)


def check_pipeline_compatible(cfg: ModelConfig, num_stages: int) -> None:
    """Stages slice the decoder stack by whole units, so the stack must be
    decoder-only with at least ``num_stages`` units.  Heterogeneous groups
    and dense-impl MoE are fine; expert-parallel MoE is not."""
    problems = []
    if cfg.enc_layers:
        problems.append("encoder-decoder stacks (enc_layers > 0)")
    if cfg.frontend:
        problems.append("modality frontends")
    if cfg.moe is not None and cfg.moe.impl == "ep":
        problems.append("expert-parallel MoE (nested shard_map; use "
                        "impl='dense')")
    n_units = sum(count for _u, count in layer_groups(cfg))
    if num_stages <= 0 or num_stages > n_units:
        problems.append(f"{n_units} scan units cannot fill {num_stages} "
                        f"stages")
    if problems:
        raise ValueError(f"{cfg.name}: not pipeline-partitionable — "
                         + "; ".join(problems))


def check_tensor_parallel_compatible(cfg: ModelConfig,
                                     model_parallel: int) -> None:
    """The reference's check for column/row-sharded stages: head counts
    and the FFN width divide, and only dense GQA stacks qualify."""
    if model_parallel <= 1:
        return
    problems = []
    mixers = {m for unit, _c in layer_groups(cfg) for m, _f in unit}
    ffns = {f for unit, _c in layer_groups(cfg) for _m, f in unit}
    bad = sorted(mixers - {"attn", "local"})
    if bad:
        problems.append(f"mixer kinds {bad} have no tensor-parallel path")
    if "moe" in ffns:
        problems.append("MoE FFNs shard over the expert axis, not "
                        "column/row")
    for nm, v in (("num_heads", cfg.num_heads),
                  ("num_kv_heads", cfg.num_kv_heads),
                  ("d_ff", cfg.d_ff)):
        if v % model_parallel:
            problems.append(f"{nm}={v} not divisible by "
                            f"model_parallel={model_parallel}")
    if problems:
        raise ValueError(f"{cfg.name}: not tensor-partitionable — "
                         + "; ".join(problems))


def stage_param_specs(stacked: Any, mesh=None, *, axis_name: str = "stage"):
    """Per-leaf specs of stage-stacked params: the column/row rule of the
    per-stage view (the dims after the stage axis), the stage axis
    prepended on dim 0 (index logic only, as ``dist/sharding.py``)."""

    def one(path, leaf):
        inner = shd.param_leaf_spec(path, tuple(leaf.shape[1:]), mesh=mesh)
        entries = [axis_name] + list(inner)
        while len(entries) > 1 and entries[-1] is None:
            entries.pop()
        return shd.P(*entries)

    return tree_map_with_path(one, stacked)


def model_shard_dim(path, shape) -> Union[int, None]:
    """The dim of a group's stacked leaf ``(count, ...)`` that the
    ``model`` axis shards (the column/row rule of the per-layer view, one
    dim on from the stack's), or None for a leaf every model rank holds
    whole."""
    spec = shd.param_leaf_spec(path, tuple(shape[1:]))
    for i, e in enumerate(spec):
        if e is not None and "model" in (e if isinstance(e, tuple) else (e,)):
            return i + 1
    return None


def model_shard(t, path, model: Tuple[int, int]):
    """Model rank ``model[0]``'s shard (of ``model[1]``) of a group's
    stacked leaf ``t`` (a view), ``t`` itself for a leaf held whole."""
    index, size = model
    dim = model_shard_dim(path, t.shape) if size > 1 else None
    if dim is None:
        return t
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def layers_per_stage(cfg: ModelConfig, num_stages: int) -> int:
    l_ = total_layers(cfg)
    if l_ % num_stages:
        raise ValueError(f"{l_} layers not divisible by {num_stages} stages")
    return l_ // num_stages


def _as_stage_map(cfg: ModelConfig, stages: Union[int, StageMap]) -> StageMap:
    return stages if isinstance(stages, StageMap) else \
        build_stage_map(cfg, stages)


# ---------------------------------------------------------------------------
# The reference's stage-stacked layout
# ---------------------------------------------------------------------------

def stack_stage_params(groups: List[Any], cfg: ModelConfig,
                       stages: Union[int, StageMap]):
    """``params['groups']`` -> stage-stacked tree: a trivial map reshapes
    every ``(count, ...)`` leaf to ``(S, count/S, ...)``; otherwise
    ``{"g0": ..., "g1": ...}`` of ``(S, caps[g], ...)`` leaves, stage
    ``s``'s rows at ``[0:count]`` and zero rows beyond."""
    smap = _as_stage_map(cfg, stages)
    s_ = smap.num_stages
    if smap.trivial:
        (g,) = groups
        return tree_map(lambda t: t.reshape((s_, t.shape[0] // s_)
                                            + tuple(t.shape[1:])), g)
    uniform = smap.uniform
    out: Dict[str, Any] = {}
    for g, gtree in enumerate(groups):
        cap = smap.caps[g]
        if uniform[g]:
            out[f"g{g}"] = tree_map(
                lambda t, cap=cap: t.reshape((s_, cap) + tuple(t.shape[1:])),
                gtree)
            continue
        per_stage = [smap.rows(s)[g] for s in range(s_)]

        def stack_leaf(t, per_stage=per_stage, cap=cap):
            rows = []
            for st, cnt in per_stage:
                blk = t[st:st + cnt]
                if cnt < cap:
                    blk = torch.cat([blk, t.new_zeros(
                        (cap - cnt,) + tuple(t.shape[1:]))])
                rows.append(blk)
            return torch.stack(rows)

        out[f"g{g}"] = tree_map(stack_leaf, gtree)
    return out


def unstack_stage_grads(stage_grads, cfg: ModelConfig,
                        stages: Union[int, StageMap]) -> List[Any]:
    """Inverse of :func:`stack_stage_params`, back to ``params['groups']``
    layout; pad rows are dropped."""
    smap = _as_stage_map(cfg, stages)
    if smap.trivial:
        return [tree_map(lambda t: t.reshape((t.shape[0] * t.shape[1],)
                                             + tuple(t.shape[2:])),
                         stage_grads)]
    out = []
    for g in range(len(smap.caps)):
        pieces = [(s, smap.rows(s)[g][1]) for s in range(smap.num_stages)
                  if smap.rows(s)[g][1]]
        out.append(tree_map(
            lambda t, pieces=pieces: torch.cat([t[s, :cnt]
                                                for s, cnt in pieces]),
            stage_grads[f"g{g}"]))
    return out


def stage_weights(groups: List[Any], smap: StageMap):
    """What stage fns take as ``w`` from a rank's own rows of each group
    (:func:`local_groups`): the group tree for a trivial map, else
    ``{"g<g>": rows}`` (the fns slice ``[:count]``, a no-op on exact
    rows)."""
    if smap.trivial:
        return groups[0]
    return {f"g{g}": gp for g, gp in enumerate(groups)}


# ---------------------------------------------------------------------------
# A rank's share of the whole tree
# ---------------------------------------------------------------------------

def _rows_of(t, st: int, cnt: int):
    return t[st:st + cnt]


def local_groups(groups: List[Any], smap: StageMap, stage: int, *,
                 take: Callable = _rows_of, is_leaf=None,
                 model: Tuple[int, int] = (0, 1)) -> List[Any]:
    """``stage``'s rows of each group (views; zero rows of a group it does
    not touch): ``take(leaf, first unit, count)`` of each leaf, then, of a
    tensor, model rank ``model[0]``'s shard of ``model[1]``
    (:func:`model_shard`)."""

    def one(path, t, st, cnt):
        t = take(t, st, cnt)
        return model_shard(t, path, model) if isinstance(t, torch.Tensor) \
            else t

    return [tree_map_with_path(
        lambda path, t, st=st, cnt=cnt: one(path, t, st, cnt), gp,
        is_leaf=is_leaf)
            for gp, (st, cnt) in zip(groups, smap.rows(stage))]


def owned_head(cfg: ModelConfig, num_stages: int, stage: int
               ) -> Dict[str, Tuple[str, ...]]:
    """The leaves outside the groups that ``stage`` owns (holds and
    updates): the token table on the first stage, the final norm and an
    untied unembedding on the last."""
    out: Dict[str, Tuple[str, ...]] = {}
    embed = (("tok",) if stage == 0 else ()) + (
        ("unembed",) if stage == num_stages - 1 and not cfg.tie_embeddings
        else ())
    if embed:
        out["embed"] = embed
    if stage == num_stages - 1:
        out["final_norm"] = ()
    return out


def local_tree(tree: Dict[str, Any], cfg: ModelConfig, smap: StageMap,
               stage: int, *, take: Callable = _rows_of,
               is_leaf=None, model: Tuple[int, int] = (0, 1)
               ) -> Dict[str, Any]:
    """``stage``'s share of a whole params-shaped tree (the params, one
    optimizer key, their specs): its rows of the groups (``take``, as
    :func:`local_groups`; model rank ``model[0]``'s shard of ``model[1]``)
    and the leaves :func:`owned_head` gives it, whole."""
    out: Dict[str, Any] = {"groups": local_groups(
        tree["groups"], smap, stage, take=take, is_leaf=is_leaf,
        model=model)}
    for key, sub in owned_head(cfg, smap.num_stages, stage).items():
        out[key] = {k: tree[key][k] for k in sub} if sub else tree[key]
    return out


def assemble(parts: Sequence[Dict[str, Any]], cfg: ModelConfig,
             smap: StageMap, model_parallel: int = 1) -> Dict[str, Any]:
    """The whole tree back from every ``(stage, model rank)``'s
    :func:`local_tree`, in that order (``parts[s * T + t]``): each group
    leaf's model shards joined on their dim and the stages' rows
    concatenated, each head leaf from its owner's model rank 0.  Inverse
    of :func:`local_tree`."""
    T = model_parallel

    def join(path, *ts):
        dim = model_shard_dim(path, ts[0].shape) if T > 1 else None
        return ts[0] if dim is None else torch.cat(ts, dim)

    out: Dict[str, Any] = {"embed": {}}
    groups = []
    for g in range(len(smap.caps)):
        held = [tree_map_with_path(join, *(parts[s * T + t]["groups"][g]
                                           for t in range(T)))
                for s in range(smap.num_stages) if smap.rows(s)[g][1]]
        groups.append(tree_map(lambda *ts: torch.cat(ts), *held))
    out["groups"] = groups
    for s, p in enumerate(parts[::T]):
        for key, sub in owned_head(cfg, smap.num_stages, s).items():
            if sub:
                out[key].update({k: p[key][k] for k in sub})
            else:
                out[key] = p[key]
    return out


# ---------------------------------------------------------------------------
# Stage functions and the head
# ---------------------------------------------------------------------------

def _sp_inlet(x, tp, sequence_parallel: bool):
    return L.sp_slice(x, tp, 1) if tp is not None and sequence_parallel \
        else x


def _sp_outlet(x, tp, sequence_parallel: bool):
    return L.sp_unslice(x, tp, 1) if tp is not None and sequence_parallel \
        else x


def make_stage_fn(cfg: ModelConfig, *, tp_group=None,
                  sequence_parallel: bool = False,
                  remat: str = "none") -> Callable:
    """One stage of a trivial (single homogeneous group) map: run this
    stage's rows of the group.  ``w`` is the stage's group tree
    (``(count/S, ...)`` leaves), ``x`` is ``(mb, seq, d_model)``.

    ``tp_group`` (a ``dist/group.ModelGroup``): ``w`` holds this model
    rank's shards and the layers join over the group; with
    ``sequence_parallel`` the stage slices its whole input over the
    sequence at the inlet and gathers it at the outlet."""
    (unit, _count) = layer_groups(cfg)[0]

    def stage_fn(w, x):
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = _sp_inlet(x, tp_group, sequence_parallel)
        x, _aux = lm._run_group_train(x, aux, w, unit, cfg, positions,
                                      remat=remat, tp=tp_group,
                                      sequence_parallel=sequence_parallel)
        return _sp_outlet(x, tp_group, sequence_parallel)

    return stage_fn


def make_stage_fns(cfg: ModelConfig, stages: Union[int, StageMap], *,
                   tp_group=None, sequence_parallel: bool = False,
                   remat: str = "none") -> List[Callable]:
    """Per-stage callables of a (possibly heterogeneous) stage map: stage
    ``s`` slices its rows of each group (``w["g<g>"][:count]``; ``w`` is
    the group tree itself for a trivial map) and runs them in stack order
    under the recompute policy ``remat``; each returns ``(x, aux)``.
    ``tp_group`` and ``sequence_parallel`` as :func:`make_stage_fn`'s."""
    smap = _as_stage_map(cfg, stages)
    groups = layer_groups(cfg)

    def one(s: int) -> Callable:
        segs = smap.segments[s]

        def stage_fn(w, x):
            positions = torch.arange(x.shape[1], device=x.device)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            wg = {"g0": w} if smap.trivial else w
            x = _sp_inlet(x, tp_group, sequence_parallel)
            for g, _start, cnt in segs:
                unit, _count = groups[g]
                gp = tree_map(lambda t: t[:cnt], wg[f"g{g}"])
                x, aux = lm._run_group_train(
                    x, aux, gp, unit, cfg, positions, remat=remat,
                    tp=tp_group, sequence_parallel=sequence_parallel)
            return _sp_outlet(x, tp_group, sequence_parallel), aux

        return stage_fn

    return [one(s) for s in range(smap.num_stages)]


def make_head_loss(cfg: ModelConfig) -> Callable:
    """The last stage's loss: final norm + unembed + xent over one
    microbatch; ``hp`` holds ``final_norm`` and ``embed`` (the table whose
    unembedding gradient flows back here)."""

    def head_loss(hp, y, labels):
        x = L.rms_norm(y, hp["final_norm"], cfg.norm_eps)
        logits = L.unembed(hp["embed"], x, cfg)
        return L.softmax_xent(logits, labels, valid_vocab=cfg.vocab_size)

    return head_loss


def head_params_of(params: Dict[str, Any]) -> Dict[str, Any]:
    return {"final_norm": params["final_norm"], "embed": params["embed"]}


def embed_tokens(embed_params, tokens, cfg: ModelConfig):
    """The token embedding at the pipeline's inlet."""
    return L.embed(embed_params, tokens, cfg)
