"""Logical-axis sharding rules and the ZeRO train-state layout (the
counterpart of ``repro/dist/sharding.py``): one rule table maps logical
tensor roles to mesh axes, and the parameter, batch, cache and train-state
specs all derive from it.

Everything here is index logic: no tensor is placed and no collective
runs.  A :class:`Mesh` (axis names and sizes) plays the reference's
``AbstractMesh`` and a :class:`P` (a tuple, as ``PartitionSpec`` is) its
spec.  Trees are the port's nested dicts and lists; a leaf's path is its
keys as strings, list positions as ``str(i)``, which is what the
reference's ``_path_keys`` yields on the same tree, so the rules that key
on names (``_COL_KEYS``, ``_ROW_KEYS``, ``"ffn"``, ``"groups"``) agree
leaf by leaf.

Eager PyTorch has no ambient mesh: where the reference reads one, the
port has none, so a spec keeps every axis its rule names unless a mesh is
passed.  The reference's ``shard(x, *roles)``, a GSPMD layout constraint on
an activation, has no counterpart: every rank's activations are its own.
A data group places its shards by hand (``dist/group.DataGroup``,
``optim/optimizers.apply_updates``), with :func:`shard_slices` saying which
slice of each leaf a rank holds.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.config import layer_groups
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

Role = Union[str, None]


class P(tuple):
    """A partition spec: one entry a dim, each ``None``, an axis name or a
    tuple of axis names (the counterpart of ``jax.sharding.PartitionSpec``;
    trailing ``None`` entries are kept as given)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Mesh axes by name and size, devices aside (the reference's
    ``AbstractMesh``)."""

    def __init__(self, axis_sizes: Sequence[int], axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for "
                             f"{len(axis_names)} axes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, map(int, axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and \
            (self.axis_names, self.shape) == (other.axis_names, other.shape)

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.shape.values())))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def mesh_for(group) -> Mesh:
    """A group's mesh, axes ``("data", "model")``: a data group's of
    ``(n, 1)``, as the reference's ``make_host_mesh`` lays out its devices;
    a ``(data, model)`` grid's (``dist/group.GridGroup``) of ``(D, T)``."""
    model = getattr(group, "model", None)
    if model is not None:
        return Mesh((group.data.size, model.size), ("data", "model"))
    return Mesh((group.size, 1), ("data", "model"))


# logical role -> mesh axis (or tuple of axes).  'batch' expands over every
# data-parallel axis of the mesh ('pod' outer axis included).
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "kv_seq": None,
    "heads": "model",
    "vocab": "model",
    "model": "model",
    "expert": "model",
    "stage": "stage",       # dropped on meshes without a pipeline axis
}

_overrides: contextvars.ContextVar[Optional[Dict[str, Any]]] = \
    contextvars.ContextVar("sharding_rules_overrides", default=None)


@contextlib.contextmanager
def rules(overrides: Optional[Dict[str, Any]] = None):
    """Scoped rule overrides, e.g. ``rules({'batch': None})``."""
    token = _overrides.set({**(_overrides.get() or {}), **(overrides or {})})
    try:
        yield
    finally:
        _overrides.reset(token)


def _rule(role: str):
    ov = _overrides.get()
    if ov is not None and role in ov:
        return ov[role]
    return DEFAULT_RULES.get(role)


def spec_for(roles: Sequence[Role], mesh: Optional[Mesh] = None) -> P:
    """Resolve logical roles to a :class:`P`.

    Axes absent from ``mesh`` are dropped (without a mesh, none is); an
    axis already consumed by an earlier dim loses to the first user (keeps
    specs valid when an override points two roles at the same axis)."""
    mesh_axes = set(mesh.axis_names) if mesh is not None else None
    used: set = set()
    out = []
    for role in roles:
        axes = None if role is None else _rule(role)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        keep = tuple(a for a in axes
                     if (mesh_axes is None or a in mesh_axes)
                     and a not in used)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(keep)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


# ---------------------------------------------------------------------------
# Parameter / batch / cache specs
# ---------------------------------------------------------------------------

# weights whose LAST dim is tensor-parallel ("column" parallel)
_COL_KEYS = {"wq", "wk", "wv", "wg", "wu", "wdkv", "wkr", "wuk", "wuv",
             "wdq", "wuq", "in_proj", "in_x", "in_z", "unembed"}
# weights whose SECOND-TO-LAST dim is tensor-parallel ("row" parallel)
_ROW_KEYS = {"wo", "wd", "out_proj"}


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _param_spec(keys: Tuple[str, ...], shape, mesh) -> P:
    name = keys[-1] if keys else ""
    nd = len(shape)
    in_expert = name in ("wg", "wu", "wd") and "ffn" in keys and nd >= 4
    if name == "tok":
        return spec_for(("vocab",) + (None,) * (nd - 1), mesh=mesh)
    if in_expert:
        # stacked (count, E, D, F): experts over the EP axis
        return spec_for((None,) * (nd - 3) + ("expert", None, None),
                        mesh=mesh)
    if name in _COL_KEYS and nd >= 2:
        return spec_for((None,) * (nd - 1) + ("model",), mesh=mesh)
    if name in _ROW_KEYS and nd >= 2:
        return spec_for((None,) * (nd - 2) + ("model", None), mesh=mesh)
    return P()


def params_pspec(params_shapes: Any, mesh: Optional[Mesh] = None) -> Any:
    """A spec tree for LM params (tensors, meta tensors or anything with a
    ``shape``)."""
    return tree_map_with_path(
        lambda keys, leaf: _param_spec(keys, _shape(leaf), mesh),
        params_shapes)


def batch_pspec(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """Batch inputs: leading dim over the DP axes, rest replicated."""
    return tree_map(
        lambda leaf: spec_for(("batch",) + (None,) * (len(_shape(leaf)) - 1),
                              mesh=mesh), batch)


def _cache_spec(keys: Tuple[str, ...], shape, mesh) -> P:
    name = keys[-1] if keys else ""
    nd = len(shape)
    if name in ("k", "v") and nd >= 5:
        # stacked (count, B, W, Hkv, Dh)
        return spec_for((None,) * (nd - 4) + ("batch", "kv_seq", "heads",
                                              None), mesh=mesh)
    if name in ("ckv", "kr") and nd >= 4:
        # stacked (count, B, S, r)
        return spec_for((None,) * (nd - 3) + ("batch", "kv_seq", None),
                        mesh=mesh)
    if nd >= 2 and name not in ("pos",):
        # generic stacked per-layer state: (count, B, ...)
        return spec_for((None, "batch") + (None,) * (nd - 2), mesh=mesh)
    return P()


def cache_pspec(cache_shapes: Any, mesh: Optional[Mesh] = None) -> Any:
    """A spec tree for a KV/state cache."""
    return tree_map_with_path(
        lambda keys, leaf: _cache_spec(keys, _shape(leaf), mesh),
        cache_shapes)


def _paged_spec(keys: Tuple[str, ...], shape, mesh) -> P:
    """Paged pool leaves: any physical page can belong to any slot, so the
    page dim must not shard over a data axis.  Only the KV-head dim
    shards, over ``model``."""
    name = keys[-1] if keys else ""
    nd = len(shape)
    if name in ("k", "v") and nd >= 4:
        # stacked (count, pages, page_size, Hkv, Dh)
        return spec_for((None,) * (nd - 2) + ("heads", None), mesh=mesh)
    return P()                  # mla ckv/kr pages: latent dims, replicated


def paged_cache_pspec(cache_shapes: Any, mesh: Optional[Mesh] = None) -> Any:
    """A spec tree for a serve engine's paged KV pool."""
    return tree_map_with_path(
        lambda keys, leaf: _paged_spec(keys, _shape(leaf), mesh),
        cache_shapes)


def serve_state_pspec(state_shapes: Any, mesh: Optional[Mesh] = None) -> Any:
    """Specs for a serve engine's state: the paged pool per
    :func:`paged_cache_pspec`; the slot bookkeeping replicated."""
    out = {}
    for key, sub in state_shapes.items():
        if key == "groups":
            out[key] = paged_cache_pspec(sub, mesh=mesh)
        else:
            out[key] = tree_map(lambda _: P(), sub)
    return out


# ---------------------------------------------------------------------------
# Train-state specs (ZeRO-1 optimizer-state sharding)
# ---------------------------------------------------------------------------

def _mesh_sizes(mesh) -> Dict[str, int]:
    """axis name -> size, for a :class:`Mesh` and for anything with
    ``axis_names`` and ``shape`` or ``devices`` (the reference's meshes)."""
    shape = getattr(mesh, "shape", None)
    if shape is not None:
        return {str(k): int(v) for k, v in dict(shape).items()}
    return dict(zip(mesh.axis_names, (int(d) for d in mesh.devices.shape)))


def dp_partition_plan(spec: P, shape, mesh
                      ) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """The per-leaf ZeRO partition plan: ``(dim, dp_axes)`` or ``None``.

    Picks the dim a leaf's optimizer state shards over the data-parallel
    axes.  Dims another mesh axis claims are never candidates; among the
    free dims the largest one the DP size divides wins (ties go to the
    earlier dim).  When the full ``('pod', 'data')`` product divides
    nothing, the plan retries with ``pod`` dropped.  ``None``: the leaf
    stays replicated (it already shards over a DP axis, or no dim fits)."""
    dp = [a for a in ("pod", "data") if a in mesh.axis_names]
    if not dp:
        return None
    sizes = _mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if used & set(dp):
        return None
    free = [(i, d) for i, (e, d) in enumerate(zip(entries, shape))
            if e is None]
    for drop in range(len(dp)):
        axes = tuple(dp[drop:])
        n = math.prod(sizes[a] for a in axes)
        if n <= 1:
            continue
        best_i, best_dim = None, 0
        for i, d in free:
            if d % n == 0 and d >= n and d > best_dim:
                best_i, best_dim = i, d
        if best_i is not None:
            return best_i, axes
    return None


def _apply_plan(spec: P, shape, plan) -> P:
    if plan is None:
        return spec
    i, axes = plan
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries[i] = axes if len(axes) > 1 else axes[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def zero1_spec(spec: P, shape, mesh) -> P:
    """ZeRO-1: an optimizer-state leaf also shards over the DP axes on the
    dim :func:`dp_partition_plan` picks."""
    return _apply_plan(spec, shape, dp_partition_plan(spec, shape, mesh))


def zero2_spec(spec: P, shape, mesh) -> P:
    """ZeRO-2: gradients shard exactly like the ZeRO-1 moments (the same
    plan), so the moment update is shard-local."""
    return zero1_spec(spec, shape, mesh)


def param_leaf_spec(path, shape, mesh: Optional[Mesh] = None) -> P:
    """The tensor-parallel column/row rule of one param leaf, addressed by
    its path and bare shape."""
    return _param_spec(tuple(str(k) for k in path), tuple(shape), mesh)


def _itemsize(leaf) -> int:
    dt = getattr(leaf, "dtype", None)
    return dt.itemsize if dt is not None else 4


def sharded_state_bytes(state_shapes: Any, specs: Any, mesh) -> int:
    """Per-device bytes of a state tree under its specs: each leaf's bytes
    divided by the product of the mesh-axis sizes its spec consumes (a
    leaf without a dtype, the step counter, counts 4 bytes an element)."""
    sizes = _mesh_sizes(mesh)
    total = 0

    def leaf_bytes(spec, leaf):
        nonlocal total
        n = 1
        for e in spec:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= sizes.get(a, 1)
        total += (math.prod(_shape(leaf)) * _itemsize(leaf)) // n
        return spec

    tree_map(leaf_bytes, specs, state_shapes, is_leaf=_is_spec)
    return total


def _zero1_opt(opt_specs: Dict[str, Any], opt_shapes: Dict[str, Any],
               mesh) -> Dict[str, Any]:
    return {key: tree_map(lambda s, leaf: zero1_spec(s, _shape(leaf), mesh),
                          sub, opt_shapes[key], is_leaf=_is_spec)
            for key, sub in opt_specs.items()}


def state_pspec(state_shapes: Any, mesh: Optional[Mesh] = None, *,
                zero1: bool = False) -> Dict[str, Any]:
    """Specs for a full train state (``{'params', 'opt', 'step'}``)."""
    opt = {key: params_pspec(sub, mesh=mesh)
           for key, sub in state_shapes["opt"].items()}
    if zero1 and mesh is not None:
        opt = _zero1_opt(opt, state_shapes["opt"], mesh)
    return {"params": params_pspec(state_shapes["params"], mesh=mesh),
            "opt": opt, "step": P()}


def _with_stage_dim0(spec: P, shape, stage_axes) -> P:
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if entries and entries[0] is None:
        entries[0] = stage_axes
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def pipeline_state_pspec(state_shapes: Any, mesh: Optional[Mesh] = None, *,
                         zero1: bool = False, uniform_groups=None
                         ) -> Dict[str, Any]:
    """Train-state specs for a pipeline session: every leaf under
    ``groups`` (params and optimizer state) also shards its leading layer
    axis over ``stage``, unless ``uniform_groups`` marks its group uneven
    or the stage size does not divide it; ZeRO-1 then shards the optimizer
    state over the DP axes on another dim."""
    stage_spec = spec_for(("stage",), mesh=mesh)
    if not len(stage_spec):                # no stage axis on this mesh
        return state_pspec(state_shapes, mesh=mesh, zero1=zero1)
    (stage_axes,) = stage_spec
    sizes = dict(getattr(mesh, "shape", {}) or {})
    ssize = math.prod(int(sizes.get(ax, 1)) for ax in (
        stage_axes if isinstance(stage_axes, tuple) else (stage_axes,)))
    base = state_pspec(state_shapes, mesh=mesh, zero1=False)

    def add(keys, spec, leaf):
        if "groups" not in keys:
            return spec
        if uniform_groups is not None:
            g = int(keys[keys.index("groups") + 1])
            if not (g < len(uniform_groups) and uniform_groups[g]):
                return spec
        shape = _shape(leaf)
        if ssize > 1 and shape and shape[0] % ssize:
            return spec                    # uneven leading dim: replicate
        return _with_stage_dim0(spec, shape, stage_axes)

    out = tree_map_with_path(add, base, state_shapes, is_leaf=_is_spec)
    if zero1 and mesh is not None:
        out["opt"] = _zero1_opt(out["opt"], state_shapes["opt"], mesh)
    return out


# The ``(data, model)`` grid of expert parallelism shards a MoE layer's
# experts over ``model`` (the ``"expert"`` rule) and nothing else: every
# other leaf is replicated there, where GSPMD would also shard heads and
# vocab over ``model`` (the port's tensor-parallel layers cover a
# pipeline's dense attn/local stages only).  The rule overrides that say so:
EXPERT_ONLY = {"heads": None, "vocab": None, "model": None}


def grid_state_pspec(state_shapes: Any, mesh: Mesh, *,
                     zero1: bool = False) -> Dict[str, Any]:
    """Train-state specs on a ``(data, model)`` grid: :func:`state_pspec`
    under :data:`EXPERT_ONLY`, so only the experts shard over ``model`` and
    ZeRO-1 picks its data dim among every other dim."""
    with rules(EXPERT_ONLY):
        return state_pspec(state_shapes, mesh, zero1=zero1)


# The serving grid (``serve/engine.ServeEngine(group=)``,
# ``dist/steps.shard_decode_step``) keeps the reference's rule table for the
# layers the port runs tensor-parallel -- an attn/local mixer's heads and a
# dense FFN's columns over ``model``, a MoE layer's experts there too -- and
# departs from it where the port has no sharded path: an MLA, SSD, RG-LRU or
# cross-attending (``xdec``) mixer runs whole on every model rank, as do a MoE
# layer's router and shared expert, the token table, the head, the norms and
# an encoder (the reference shards ``vocab``, the MLA projections and the
# shared expert over ``model`` too).  Only the leaves the rule left
# sharded are kept: a rank's weights, dense caches and paged pools then hold
# ``1 / T`` of each attention layer's KV heads.
#
# An attn/local mixer also runs whole where its cache does not shard the KV
# heads over ``model``: under a ``kv_seq`` override that takes ``model``
# (:func:`spec_for`'s first user wins, so the reference's cache holds every
# head on every rank there, and each rank attends all heads over its share
# of the sequence instead of gathering q), or under ``heads: None``.  Under
# ``model: None`` the attention and the dense FFNs run whole, under
# ``expert: None`` the experts (:func:`grid_whole`).
_TP_MIXERS = ("attn", "local")

# the data-parallel axes, which ``batch`` spans by default
DP_AXES = ("pod", "data")
# the axes of a serving grid: ``kv_seq`` may take any of them
GRID_AXES = ("pod", "data", "model")


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names, as a tuple."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def check_overrides(overrides: Optional[Dict[str, Any]]) -> None:
    """Raise for a rule override the serving grid has no path for.  Paths:
    any role set to None, ``batch`` on a subset of :data:`DP_AXES`,
    ``kv_seq`` on any tuple of :data:`GRID_AXES` (the axes ``batch`` takes
    first are dropped, as :func:`spec_for` drops them), and a role left on
    its default axis.  A role moved onto another axis (``{"heads":
    "data"}``, ``{"expert": "data"}``) raises ``NotImplementedError``: the
    port's tensor-parallel and expert-parallel layers shard over the model
    group only (ROADMAP.md Queue 3, deliberate differences)."""
    for role, axes in (overrides or {}).items():
        names = axes_of(axes)
        if (axes is None
                or (role == "batch" and set(names) <= set(DP_AXES))
                or (role == "kv_seq" and set(names) <= set(GRID_AXES))
                or names == axes_of(DEFAULT_RULES.get(role))):
            continue
        raise NotImplementedError(
            f"sharding-rule override {role!r}: {axes!r} moves a role onto "
            f"another axis; the port's tensor- and expert-parallel layers "
            f"shard over the model group only (ROADMAP.md Queue 3, "
            f"deliberate differences)")


def seq_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    """The mesh axes a dense cache's sequence dim shards over under the
    rules in force: ``kv_seq``'s axes that ``batch`` leaves free, in its
    order (``()`` without a ``kv_seq`` override)."""
    spec = spec_for((None, "batch", "kv_seq"), mesh=mesh)
    return axes_of(spec[2] if len(spec) > 2 else None)


def batch_ranks(mesh: Mesh) -> int:
    """The ranks a batch's rows split over on ``mesh`` under the rules in
    force (the product of ``batch``'s axes; 1 under ``batch: None``)."""
    spec = spec_for(("batch",), mesh=mesh)
    return math.prod(mesh.shape.get(a, 1)
                     for a in axes_of(spec[0] if spec else None))


def grid_whole(mesh: Optional[Mesh]) -> frozenset:
    """The layer kinds the serving grid runs whole on every model rank
    under the rules in force, of ``"attn"`` (an attn/local mixer: where the
    cache's KV-head dim does not shard over ``model``), ``"ffn"`` (a dense
    FFN: ``model: None``) and ``"moe"`` (the experts: ``expert: None``)."""
    def on_model(roles, at):
        spec = spec_for(roles, mesh=mesh)
        return len(spec) > at and spec[at] == "model"

    whole = set()
    if not (on_model((None, "batch", "kv_seq", "heads"), 3)
            and on_model(("model",), 0)):
        whole.add("attn")
    if not on_model(("model",), 0):
        whole.add("ffn")
    if not on_model(("expert",), 0):
        whole.add("moe")
    return frozenset(whole)


def _layer_route(keys: Tuple[str, ...], cfg) -> Optional[Tuple[str, str]]:
    """The ``(mixer, ffn)`` kinds of the decoder layer a param or cache
    leaf belongs to (its path under ``groups``), or None outside the
    decoder's groups (the embedding, the head, an encoder, ``pos``)."""
    if len(keys) < 3 or keys[0] != "groups":
        return None
    unit, _ = layer_groups(cfg)[int(keys[1])]
    return unit[int(keys[2])]


def _grid_keeps(keys: Tuple[str, ...], cfg, whole: frozenset) -> bool:
    """Whether a leaf keeps its rule-table spec on the serving grid (else
    it is whole on every model rank); ``whole`` as :func:`grid_whole`'s."""
    route = _layer_route(keys, cfg)
    if route is None:
        return False
    mixer, ffn = route
    if keys[3] in ("mixer", "self"):
        return mixer in _TP_MIXERS and "attn" not in whole
    if keys[3] == "ffn":
        if ffn != "moe":
            return "ffn" not in whole
        # a MoE layer: its experts' stacked (count, E, D, F) leaves only
        return "moe" not in whole and keys[-1] in ("wg", "wu", "wd") \
            and "shared" not in keys
    return False


def _kept_or_whole(specs: Any, shapes: Any, cfg, mesh) -> Any:
    """``specs`` with every leaf the serving grid holds whole replaced by
    ``P()``."""
    whole = grid_whole(mesh)
    return tree_map_with_path(
        lambda keys, spec, leaf: spec if _grid_keeps(keys, cfg, whole)
        else P(), specs, shapes, is_leaf=_is_spec)


def serve_params_pspec(params_shapes: Any, cfg, mesh: Mesh) -> Any:
    """Param specs on the serving grid (``(data, model)``, a data index's
    T ranks a model group; ``(pod, data, model)``): the rule table's
    column/row specs for the attn/local mixers and dense FFNs, the experts
    over ``model``, every other leaf whole (the departures above).
    Nothing shards over a DP axis: data replicas serve the same slots."""
    return _kept_or_whole(params_pspec(params_shapes, mesh=mesh),
                          params_shapes, cfg, mesh)


def serve_grid_state_pspec(state_shapes: Any, cfg, mesh: Mesh) -> Any:
    """A serve engine's state specs on the serving grid: an attn/local
    layer's paged K/V pool over ``model`` on its KV-head dim (the
    reference's ``_paged_spec``: the page dim never shards over ``data``),
    an MLA layer's latent pool and the slot bookkeeping whole."""
    specs = serve_state_pspec(state_shapes, mesh=mesh)
    specs["groups"] = _kept_or_whole(
        {"groups": specs["groups"]}, {"groups": state_shapes["groups"]},
        cfg, mesh)["groups"]
    return specs


def grid_cache_pspec(cache_shapes: Any, cfg, mesh: Mesh) -> Any:
    """Dense decode-cache specs on the serving grid: :func:`cache_pspec`'s
    (the batch over the DP axes, the sequence over ``kv_seq``'s axes, an
    attn/local layer's KV heads over ``model``), with the KV-head dim of
    every other layer's cache whole (an MLA layer's latents keep their
    sequence entry: they resolve as the reference's)."""
    whole = grid_whole(mesh)
    kept = cache_pspec(cache_shapes, mesh=mesh)
    with rules({"heads": None}):
        headless = cache_pspec(cache_shapes, mesh=mesh)
    return tree_map_with_path(
        lambda keys, k, h: k if _grid_keeps(keys, cfg, whole) else h,
        kept, headless, is_leaf=_is_spec)


def _axis_sizes(spec: P, mesh: Mesh) -> list:
    """Each dim's number of shards under ``spec``."""
    return [math.prod(mesh.shape.get(a, 1) for a in axes_of(e))
            for e in spec]


def check_divides(specs: Any, shapes: Any, mesh: Mesh, what: str) -> None:
    """Raise ``ValueError`` naming the first leaf of ``shapes`` (``what``:
    the tree's name) whose dim does not split over the mesh axes its spec
    names (the refusal GSPMD makes when a layout is placed)."""
    def one(keys, spec, leaf):
        shape = _shape(leaf)
        for i, n in enumerate(_axis_sizes(spec, mesh)):
            if shape[i] % n:
                raise ValueError(
                    f"{what} leaf {'/'.join(keys)} {tuple(shape)}: dim {i} "
                    f"({shape[i]}) should be divisible by {n}, the size of "
                    f"{spec[i]!r} ({spec})")
        return spec

    tree_map_with_path(one, specs, shapes, is_leaf=_is_spec)


def local_shapes(specs: Any, shapes: Any, mesh: Mesh) -> Any:
    """Meta tensors of the block one rank holds of each leaf under
    ``specs`` (each sharded dim divided by its axes' sizes); raises where
    a dim does not divide."""
    import torch

    def one(spec, leaf):
        shape = list(_shape(leaf))
        for i, n in enumerate(_axis_sizes(spec, mesh)):
            if shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(_shape(leaf))} does "
                                 f"not split over {n} ranks ({spec})")
            shape[i] //= n
        return torch.empty(shape, dtype=leaf.dtype, device="meta")

    return tree_map(one, specs, shapes, is_leaf=_is_spec)


def _narrowing(spec: P, shape, mesh: Mesh, coords: Dict[str, int]) -> list:
    """``(dim, start, length)`` of each dim of a leaf that ``coords``
    (``{axis: index}``) narrows.  A dim sharded over the axes of its entry
    is cut into their product of blocks, numbered row-major over the axes
    as listed (the first major, as GSPMD orders a mesh's devices); the
    rank's block is the one its coords name.  An axis of the entry left out
    of ``coords`` keeps all its blocks, so it must follow every axis given
    (else the blocks are not one slice)."""
    out = []
    for i, e in enumerate(spec):
        axes = [a for a in axes_of(e) if mesh.shape.get(a, 1) > 1]
        given = [a for a in axes if a in coords]
        if not given:
            continue
        if axes[:len(given)] != given:
            raise ValueError(f"{sorted(coords)} of {e!r}: an axis left out "
                             f"precedes one given, so the blocks are not "
                             f"one slice")
        if shape[i] % math.prod(mesh.shape[a] for a in axes):
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {e!r} ({spec})")
        index = 0
        for a in given:
            index = index * mesh.shape[a] + coords[a]
        length = shape[i] // math.prod(mesh.shape[a] for a in given)
        out.append((i, index * length, length))
    return out


def grid_share(tree: Any, specs: Any, mesh: Mesh, coords: Dict[str, int]
               ) -> Any:
    """A rank's block of each tensor of ``tree`` (whole leaves) under
    ``specs``: narrowed on each dim its coords (``{axis: index}``) shard,
    a dim over several axes row-major over them (:func:`_narrowing`), a
    view of the whole leaf (``.clone()`` it to let the whole go)."""
    def one(spec, t):
        for dim, start, length in _narrowing(spec, _shape(t), mesh, coords):
            t = t.narrow(dim, start, length)
        return t

    return tree_map(one, specs, tree, is_leaf=_is_spec)


def share_keeper(specs: Any, shapes: Any, mesh: Mesh,
                 coords: Dict[str, int]):
    """``lm.init_lm``'s ``keep``: the block of each drawn leaf that a rank
    at ``coords`` holds under ``specs`` (:func:`grid_share`'s), a copy, so
    the whole leaf goes."""
    parts = {}
    tree_map_with_path(
        lambda keys, spec, leaf: parts.__setitem__(
            keys, _narrowing(spec, _shape(leaf), mesh, coords)),
        specs, shapes, is_leaf=_is_spec)

    def keep(path, leaf):
        if not parts[tuple(path)]:
            return leaf
        for dim, start, length in parts[tuple(path)]:
            leaf = leaf.narrow(dim, start, length)
        return leaf.clone()

    return keep


# ---------------------------------------------------------------------------
# A rank's slices (the port's placement by hand)
# ---------------------------------------------------------------------------

def axis_slices(specs: Any, shapes: Any, mesh: Mesh, axis: str,
                index: int) -> Any:
    """The slice of each leaf that index ``index`` of mesh axis ``axis``
    holds, a :func:`shard_slices` entry ``(dim, start, length)`` on the
    dim whose spec names ``axis`` (alone, or first of a tuple of axes:
    the others' blocks then all lie in the slice), or ``None`` for a leaf
    that axis leaves whole (a grid rank's experts: ``axis="model"``)."""
    def one(spec, leaf):
        parts = _narrowing(spec, _shape(leaf), mesh, {axis: index})
        return parts[0] if parts else None

    return tree_map(one, specs, shapes, is_leaf=_is_spec)


def mesh_coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """A rank's index on each mesh axis, devices laid out row-major."""
    out = {}
    for name in reversed(mesh.axis_names):
        rank, out[name] = divmod(rank, mesh.shape[name])
    return out


def shard_slices(specs: Any, shapes: Any, mesh: Mesh, rank: int) -> Any:
    """Which slice of each leaf a rank holds under ``specs``: a tree like
    ``shapes`` of ``(dim, start, length)`` (a ``Tensor.narrow``'s
    arguments) or ``None`` for a leaf the rank holds whole (an axis of size
    1 shards nothing).  A leaf may shard on one dim only, which is all
    ZeRO-1 over a data group makes.  The entries are tuples: walk the tree
    with ``is_leaf=``:func:`is_slice`."""
    at = mesh_coords(mesh, rank)

    def one(spec, leaf):
        dims = [(i, axes) for i, axes in (
            (i, e if isinstance(e, tuple) else (e,))
            for i, e in enumerate(spec) if e is not None)
            if math.prod(mesh.shape[a] for a in axes) > 1]
        if not dims:
            return None         # no axis of more than one device
        if len(dims) > 1:
            raise NotImplementedError(f"a leaf sharded on several dims "
                                      f"({spec}) is not placed by hand")
        i, axes = dims[0]
        index = 0
        for a in axes:          # row-major over the spec's axes
            index = index * mesh.shape[a] + at[a]
        length = _shape(leaf)[i] // math.prod(mesh.shape[a] for a in axes)
        return (i, index * length, length)

    return tree_map(one, specs, shapes, is_leaf=_is_spec)


def is_slice(x) -> bool:
    """A :func:`shard_slices` entry (a tuple), for ``is_leaf``."""
    return isinstance(x, tuple)


def opt_slices(state_shapes: Any, state_specs: Any, mesh: Mesh,
               rank: int) -> Any:
    """A rank's slice of each optimizer leaf under ``state_specs``
    (:func:`shard_slices`; every optimizer key shares the parameters'
    layout), or ``None`` when the rank holds every leaf whole."""
    key = sorted(state_shapes["opt"])[0]
    slices = shard_slices(state_specs["opt"][key], state_shapes["opt"][key],
                          mesh, rank)
    held = tree_map(lambda part: part is not None, slices, is_leaf=is_slice)
    return slices if any(tree_leaves(held)) else None


def pipeline_opt_slices(local_specs: Any, local_shapes: Any, mesh: Mesh,
                        data_index: int) -> Any:
    """A pipeline or grid rank's ZeRO-1 slice of each optimizer leaf:
    ``local_specs`` are :func:`pipeline_state_pspec`'s (or
    :func:`grid_state_pspec`'s) specs of the leaves the rank's stage holds
    (one optimizer key), ``local_shapes`` those leaves as the rank holds
    them (its rows of a group, its model shard of a tensor-parallel leaf,
    its experts).  The plan picked the DP dim among the dims no other axis
    claims (stage, then model, then data), so it is the same on the rank's
    model-sliced shape.  The ``stage`` entry is already resolved by the
    rank holding its rows; the DP entry (``data``, or ``("pod", "data")``
    on a multi-pod mesh) becomes a :func:`shard_slices` entry on the
    rank's leaf.  ``data_index`` is the rank's index over the mesh's DP
    axes, row-major.  None when the rank holds every leaf whole (DP axes
    of one)."""
    dp = [a for a in DP_AXES if a in mesh.shape]
    if math.prod(mesh.shape[a] for a in dp) <= 1:
        return None
    at = mesh_coords(Mesh([mesh.shape[a] for a in dp], dp), data_index)

    def one(spec, leaf):
        shape = _shape(leaf)
        if not math.prod(shape):
            return None
        for i, e in enumerate(spec):
            axes = axes_of(e)
            if set(axes) & set(dp):
                n = math.prod(mesh.shape[a] for a in axes)
                if shape[i] % n:
                    raise NotImplementedError(
                        f"a stage's leaf of shape {shape} does not split "
                        f"over {n} data ranks on dim {i}")
                index = 0
                for a in axes:
                    index = index * mesh.shape[a] + at[a]
                length = shape[i] // n
                return (i, index * length, length)
        return None

    return tree_map(one, local_specs, local_shapes, is_leaf=_is_spec)
