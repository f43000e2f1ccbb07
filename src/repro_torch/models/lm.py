"""LM assembly with SPB suffix splitting, dense-cache prefill/decode and
the serving engine's paged prefill/decode (``repro/models/lm.py`` for
GQA attention, MLA, Mamba-2 SSD and Griffin RG-LRU + local-attention
stacks, with dense or MoE FFNs, an encoder-decoder's bidirectional
encoder and cross-attending ``xdec`` decoder, and a modality frontend's
embeddings placed before the text).

Parameters keep the JAX package's stacked per-group layout:
``params["groups"][g][u][name]`` carries a leading ``count`` dim, one row
per repeat of the group's unit (``config.layer_groups``), so weights copy
across packages name by name and the SPB boundary index means the same in
both.

The SPB suffix depth splits a group's stacked parameters at a unit
boundary.  The frozen prefix runs under ``torch.no_grad()`` on a detached
input -- the torch form of ``stop_gradient``: autograd records nothing
for it, so no backward runs there and none of its activations are kept.
The live rows are a slice ``t[q:]`` of the stacked leaf, so the leaf's
gradient holds zeros in the frozen rows, as ``jax.grad`` returns.  The
MoE load-balancing aux of every layer, frozen or live, is summed in layer
order into the loss; the frozen layers' part carries no graph.

The layer recompute (the reference's ``REMAT``): ``remat="none"`` keeps
every live activation for the backward; ``"full"`` runs each repeat of a
live group's unit (the reference's scan body) under a non-reentrant
``torch.utils.checkpoint``, which keeps the repeat's inputs -- the
``(x, aux)`` carry -- and recomputes the rest in the backward; ``"dots"``
also keeps the outputs of the matrix products with no batch dims
(``aten.mm``/``addmm``, the reference's
``checkpoint_dots_with_no_batch_dims``) and recomputes everything else,
the kernels' Functions included.  No policy changes a number.  The
policy is resolved once, when a step is built, and passed down as
``remat=``; :data:`REMAT` gives only the default, ``"none"`` (the
reference's is ``"full"``, chosen for a 16 GB TPU).  Frozen layers run
under ``no_grad`` and are never recomputed.  :func:`swept_grads` is the
recompute in the form ``torch.func`` can batch: the forward under
``no_grad`` keeps each live repeat's carry (under 'dots' also its
products' outputs), and a ``torch.func.vjp`` of each repeat, last first,
recomputes it (replaying the kept products).

An encoder-decoder's SPB depth counts over the combined stack, the
encoder's layers first (``config.combined_layer_groups``): one boundary
freezes a prefix of the encoder, or all of it and a prefix of the
decoder.  The encoder output feeds every decoder layer's
cross-attention.  A frozen decoder layer uses it as a value with no
graph, so no gradient runs back through the frozen decoder prefix.  The
reference differs there: its frozen decoder layers stop the gradient of
their input and weights but not of the encoder output, so where the
boundary lies inside the decoder it backpropagates through them into
``enc.final_norm``.  That leaf is the only one it changes.

The cached paths (:func:`prefill`, :func:`decode_step`,
:func:`serve_prefill`, :func:`serve_decode`) run under ``no_grad`` and
update their cache tensors in place; positions, page tables and masks
are device tensors, so a decode step reads nothing back to the host.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import record_function
from torch.utils import checkpoint as _checkpoint

from repro_torch.config import ModelConfig, layer_groups, total_layers
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the profiler range of an encoder-decoder's encoder stack
# (analysis/step_profile.RANGES)
ENCODER_RANGE = "encoder"


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


_KINDS = {("attn", "dense"), ("local", "dense"), ("ssd", "dense"),
          ("rglru", "dense"), ("mla", "dense"), ("xdec", "dense"),
          ("attn", "moe"), ("mla", "moe"), ("xdec", "moe")}


def _check_supported(cfg: ModelConfig) -> None:
    kinds = {k for unit, _ in layer_groups(cfg) for k in unit}
    if kinds - _KINDS:
        raise NotImplementedError(
            f"{cfg.name}: the port runs attn/local, mla, ssd, rglru and xdec "
            f"stacks with dense FFNs and attn, mla and xdec with MoE FFNs "
            f"(got layer kinds {sorted(kinds)})")


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: ``enc_layers`` dense attention layers."""
    return cfg.scaled(num_layers=cfg.enc_layers, pattern=("attn",),
                      moe=None, enc_layers=0)


# ---------------------------------------------------------------------------
# Layout and init
# ---------------------------------------------------------------------------

def _mixer_shapes(cfg: ModelConfig, mixer: str, dtype: torch.dtype):
    """{name: (shape, dtype)} of one layer's mixer leaves."""
    D = cfg.d_model
    f32 = torch.float32
    if mixer in ("attn", "local", "xdec"):
        return {"wq": ((D, cfg.q_dim), dtype), "wk": ((D, cfg.kv_dim), dtype),
                "wv": ((D, cfg.kv_dim), dtype), "wo": ((cfg.q_dim, D), dtype)}
    if mixer == "mla":
        return L.mla_shapes(cfg, dtype)
    if mixer == "rglru":
        # repro/models/ssm.py::init_rglru; lam, ba, bx are f32 at any
        # cfg.dtype
        lru = cfg.lru
        W = lru.lru_width or D
        return {"in_x": ((D, W), dtype), "in_z": ((D, W), dtype),
                "conv_w": ((lru.d_conv, W), dtype), "conv_b": ((W,), dtype),
                "lam": ((W,), f32), "wa": ((W, W), dtype), "ba": ((W,), f32),
                "wx": ((W, W), dtype), "bx": ((W,), f32),
                "out_proj": ((W, D), dtype)}
    # ssd: repro/models/ssm.py::init_mamba2; A_log, D, dt_bias are f32 at
    # any cfg.dtype
    s = cfg.ssm
    d_in = s.expand * D
    H, GN = d_in // s.head_dim, s.n_groups * s.d_state
    conv_dim = d_in + 2 * GN
    return {"in_proj": ((D, 2 * d_in + 2 * GN + H), dtype),
            "conv_w": ((s.d_conv, conv_dim), dtype),
            "conv_b": ((conv_dim,), dtype),
            "A_log": ((H,), f32), "D": ((H,), f32), "dt_bias": ((H,), f32),
            "norm": ((d_in,), dtype),
            "out_proj": ((d_in, D), dtype)}


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as meta tensors: each leaf's shape and dtype (the
    counterpart of ``jax.eval_shape(init_lm)``), allocating nothing."""
    _check_supported(cfg)
    D, F = cfg.d_model, cfg.d_ff
    dtype = _dtype(cfg)

    def meta(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    def stacked(shapes, count):
        return {k: stacked(v, count) if isinstance(v, dict)
                else meta((count,) + v[0], v[1]) for k, v in shapes.items()}

    def layer(mixer, ffn, count):
        out = {"ln1": meta((count, D)),
               "mixer": stacked(_mixer_shapes(cfg, mixer, dtype), count)}
        if mixer == "xdec":         # cross-attention over the encoder
            out["xattn"] = stacked(_mixer_shapes(cfg, "attn", dtype), count)
            out["lnx"] = meta((count, D))
        if F > 0:
            out["ln2"] = meta((count, D))
            out["ffn"] = stacked(
                M.moe_shapes(cfg, dtype) if ffn == "moe" else
                {"wg": ((D, F), dtype), "wu": ((D, F), dtype),
                 "wd": ((F, D), dtype)}, count)
        return out

    def groups(c):
        return [[layer(mixer, ffn, count) for mixer, ffn in unit]
                for unit, count in layer_groups(c)]

    embed = {"tok": meta((cfg.padded_vocab, D))}
    if not cfg.tie_embeddings:
        embed["unembed"] = meta((D, cfg.padded_vocab))
    out = {"embed": embed, "groups": groups(cfg), "final_norm": meta((D,))}
    if cfg.enc_layers:
        out["enc"] = {"groups": groups(_encoder_cfg(cfg)),
                      "final_norm": meta((D,))}
    return out


def _init_leaf(gen: torch.Generator, name: str, like: Tensor, device):
    """The JAX package's init rules for the leaf ``name`` shaped as the
    meta tensor ``like`` (a stacked leaf's rows are drawn as one):

    - norms store scale - 1: zeros (``ln*``, ``final_norm``, the mixer's
      ``norm``, MLA's ``kv_norm`` and ``q_norm``); ``conv_b``, ``ba``,
      ``bx`` zeros;
    - the token table is N(0, 0.02); ``conv_w`` is N(0, 1) / sqrt(d_conv);
    - ``A_log`` = log(linspace(1, 16, H)), ``D`` = ones, ``dt_bias`` =
      log(expm1(dt)) with dt log-uniform in [1e-3, 1e-1];
    - ``lam`` = log(u^2 / (1 - u^2)) with u uniform in [0.9, 0.999];
    - every projection (.., fan_in, fan_out) is a normal truncated at +-2
      and scaled by 1 / sqrt(fan_in)."""
    shape, dtype = like.shape, like.dtype
    if name.startswith("ln") or name in ("final_norm", "norm", "kv_norm",
                                         "q_norm", "conv_b", "ba", "bx"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "A_log":
        a = torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device))
        return a.expand(shape).to(dtype).contiguous()
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if name == "tok":
        t.normal_(0.0, 0.02, generator=gen)
    elif name == "conv_w":
        t.normal_(0.0, 1.0, generator=gen).mul_(1.0 / math.sqrt(shape[-2]))
    elif name == "lam":
        u = t.uniform_(0.9, 0.999, generator=gen)
        t = torch.log(u ** 2 / (1 - u ** 2))
    elif name == "dt_bias":
        t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
        t = torch.log(torch.expm1(torch.exp(t)))
    else:
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(1.0 / math.sqrt(shape[-2]))
    return t.to(dtype)


def init_lm(gen: torch.Generator, cfg: ModelConfig, device=None, *,
            keep: Optional[Callable[[Tuple[str, ...], Tensor], Tensor]] = None
            ) -> Params:
    """Random parameters drawn from ``gen`` (on ``gen``'s device).  The
    layout and leaf dtypes equal ``repro.models.lm.init_lm``'s; the numbers
    differ.  ``keep(path, leaf)``, if given, makes what is kept of each
    leaf as it is drawn (a grid rank's share, ``serve/engine.py``), so
    only one whole leaf is held at a time; the draws are the same."""

    def init(tree, name, path):
        if isinstance(tree, dict):
            return {k: init(v, k, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [init(v, name, path + (str(i),))
                    for i, v in enumerate(tree)]
        leaf = _init_leaf(gen, name, tree, device)
        return leaf if keep is None else keep(path, leaf)

    return init(param_shapes(cfg), "", ())


# ---------------------------------------------------------------------------
# Forward / loss (train path with SPB suffix splitting)
# ---------------------------------------------------------------------------

def _rows(tree, lo: int, hi: int):
    return {k: _rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in tree.items()}


def _unbind(tree, count: int):
    """The per-layer trees of a stacked group, one ``unbind`` per leaf (a
    single backward node per leaf gathers all the layers' gradients)."""
    parts = {k: _unbind(v, count) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[r] for k, v in parts.items()} for r in range(count)]


def _apply_ffn(x: Tensor, up: Params, ffn: str, cfg: ModelConfig, tp=None,
               sequence_parallel: bool = False, ep=None
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """The FFN half of a layer: (x, the layer's MoE aux, or None for a
    dense FFN or none).  ``ep``: the model group a MoE layer's experts are
    sharded over (``models/moe.moe_fwd``)."""
    aux = None
    if cfg.d_ff > 0:
        h = L.rms_norm(x, up["ln2"], cfg.norm_eps)
        if ffn == "moe":
            out, aux = M.moe_fwd(up["ffn"], h, cfg, group=ep)
        else:
            out = L.ffn_fwd(up["ffn"], h, tp=tp,
                            sequence_parallel=sequence_parallel)
        x = x + out
    return x, aux


def _apply_layer(x: Tensor, up: Params, kinds, cfg: ModelConfig,
                 positions: Tensor, enc: Optional[Tensor] = None,
                 causal: bool = True, tp=None,
                 sequence_parallel: bool = False, ep=None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Returns (x, the layer's MoE aux, or None for a dense FFN).  ``enc``:
    the encoder output an ``xdec`` layer cross-attends to; ``causal=False``:
    an encoder layer's bidirectional self-attention.

    ``tp`` (a ``dist/group.ModelGroup``): the attention and FFN weights are
    column/row-sharded over it, the tensor-sharded pipeline stage's path
    (dense ``attn``/``local`` train layers only, as in the reference);
    ``sequence_parallel`` shards the residual stream between the joins
    over it on the sequence dim.  ``ep`` (a ``ModelGroup``): a MoE
    layer's experts are sharded over it (expert parallelism, everything
    else replicated)."""
    mixer, ffn = kinds
    if tp is not None and (mixer not in ("attn", "local") or ffn == "moe"):
        raise NotImplementedError(
            f"tensor-parallel path covers dense attn/local train layers "
            f"only, got mixer={mixer!r} ffn={ffn!r} mode='train'")
    h = L.rms_norm(x, up["ln1"], cfg.norm_eps)
    if mixer == "ssd":
        o = S.mamba2_fwd(up["mixer"], h, cfg)
    elif mixer == "rglru":
        o = S.rglru_fwd(up["mixer"], h, cfg)
    elif mixer == "mla":
        o = L.mla_fwd(up["mixer"], h, cfg, positions=positions)
    else:
        o = L.attention_fwd(up["mixer"], h, cfg, kind=mixer,
                            positions=positions, causal=causal, tp=tp,
                            sequence_parallel=sequence_parallel)
    x = x + o
    if mixer == "xdec":
        hx = L.rms_norm(x, up["lnx"], cfg.norm_eps)
        x = x + L.cross_attention_fwd(up["xattn"], hx, enc, cfg)
    return _apply_ffn(x, up, ffn, cfg, tp, sequence_parallel, ep)


# the cached modes' mixer functions: dense per-slot caches ('prefill',
# 'decode') and the serving engine's paged pair ('serve_prefill': one slot,
# its page row and unpadded prompt length; 'serve_decode': slot-batched,
# the whole page table and the slots' liveness)
_ATTN = {"prefill": L.attention_prefill, "decode": L.attention_decode,
         "serve_prefill": L.attention_prefill_paged,
         "serve_decode": L.attention_decode_paged}
_MLA = {"prefill": L.mla_prefill, "decode": L.mla_decode,
        "serve_prefill": L.mla_prefill_paged,
        "serve_decode": L.mla_decode_paged}
_RECURRENT = {"ssd": {"prefill": S.mamba2_prefill,
                      "decode": S.mamba2_decode},
              "rglru": {"prefill": S.rglru_prefill,
                        "decode": S.rglru_decode}}


def _cached_ffn(x: Tensor, up: Params, ffn: str, cfg: ModelConfig,
                tp, whole: frozenset = frozenset()) -> Tensor:
    """The FFN half of a cached layer: a dense FFN column/row-sharded
    over ``tp``; a MoE layer's experts over it, by ``moe_fwd_ep`` under
    ``impl="ep"`` and by ``moe_fwd_held`` under ``impl="dense"`` on a
    group of several ranks.  ``whole``: the kinds (``"ffn"``, ``"moe"``)
    whose weights the rank holds whole despite ``tp``
    (``dist/sharding.grid_whole``)."""
    ep = None if "moe" in whole else tp
    if ffn == "moe" and cfg.d_ff > 0 and cfg.moe.impl == "dense" \
            and ep is not None and ep.size > 1:
        h = L.rms_norm(x, up["ln2"], cfg.norm_eps)
        return x + M.moe_fwd_held(up["ffn"], h, cfg, group=ep)
    dense = None if ffn == "moe" or "ffn" in whole else tp
    return _apply_ffn(x, up, ffn, cfg, tp=dense, ep=ep)[0]


def _apply_layer_cached(x: Tensor, up: Params, kinds, cfg: ModelConfig,
                        cache: Params, mode: str, kw: Dict[str, Any],
                        enc: Optional[Tensor] = None, tp=None,
                        whole: frozenset = frozenset()) -> Tensor:
    """One layer of a cached mode; its cache is updated in place.  ``kw``:
    the mode's position arguments (``positions`` or ``pos``, plus the
    page table and the mask in the serve modes, and ``seq`` in a decode
    over a sequence-sharded cache).  An ``xdec`` layer's prefill fills its
    ``cross`` cache from the encoder output ``enc``; its decode reads it.

    ``tp``: the model group of the serving grid (``dist/sharding.
    serve_params_pspec``).  Each layer takes its route from its kinds: an
    attn/local mixer and a dense FFN run column/row-sharded over it, a MoE
    layer's experts are sharded over it, and an MLA, SSD, RG-LRU or
    ``xdec`` mixer runs whole on every rank, as do the kinds of ``whole``
    (``"attn"``, ``"ffn"``, ``"moe"``; ``dist/sharding.grid_whole``)."""
    mixer, ffn = kinds
    h = L.rms_norm(x, up["ln1"], cfg.norm_eps)
    if mode.startswith("serve_") and mixer in ("ssd", "rglru", "xdec"):
        raise NotImplementedError(
            f"mixer {mixer!r} has no paged serve path (kvcache.supports)")
    if mixer in _RECURRENT:
        o, _ = _RECURRENT[mixer][mode](up["mixer"], h, cfg, cache["self"])
    elif mixer == "mla":
        o, _ = _MLA[mode](up["mixer"], h, cfg, cache=cache["self"], **kw)
    else:
        attn_tp = None if mixer == "xdec" or "attn" in whole else tp
        o, _ = _ATTN[mode](up["mixer"], h, cfg, kind=mixer,
                           cache=cache["self"], tp=attn_tp, **kw)
    x = x + o
    if mixer == "xdec":
        hx = L.rms_norm(x, up["lnx"], cfg.norm_eps)
        cross = cache["cross"]
        if mode == "prefill":
            for name, t in zip(("k", "v"), L.cross_kv(up["xattn"], enc, cfg)):
                cross[name].copy_(t)
            xo = L.cross_attention_fwd(up["xattn"], hx, enc, cfg)
        else:
            xo = L.cross_attention_decode(up["xattn"], hx, cfg,
                                          (cross["k"], cross["v"]),
                                          seq=kw.get("seq"))
        x = x + xo
    return _cached_ffn(x, up, ffn, cfg, tp, whole)


# ---------------------------------------------------------------------------
# The layer recompute (the reference's REMAT / _maybe_remat)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "dots", "full")
# the default policy of a step built without ``remat=`` ('none' | 'dots' |
# 'full'; the reference's REMAT, whose own default is 'full')
REMAT: contextvars.ContextVar[str] = contextvars.ContextVar(
    "remat", default="none")
# what a recomputed repeat keeps for the backward, reported as it is kept:
# each sink is called with (tensors, bytes) -- a repeat's inputs when its
# first pass runs, and the bytes of each product output 'dots' keeps
# (analysis/cost.CostMode counts them: the checkpoint's own saved-tensor
# hooks hide them from any outer hook)
KEPT_SINKS: List[Callable[[List[Tensor], int], None]] = []

_aten = torch.ops.aten
# the products with no batch dims: a 2-D ``x @ W`` of any rank dispatches
# as ``mm`` (``addmm`` with a bias); ``bmm`` (attention scores, the MoE
# experts, einsums) has a batch dim
_DOTS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2)}


def resolve_remat(remat: Optional[str] = None) -> str:
    """``remat``, or :data:`REMAT`'s value when None; checked."""
    pol = REMAT.get() if remat is None else remat
    if pol not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {pol!r}; known: "
                         f"{', '.join(REMAT_POLICIES)}")
    return pol


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the products with no batch dims, recompute the rest."""
    ab = _DOTS.get(op)
    if ab is None:
        return _checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    if not ctx.is_recompute and KEPT_SINKS:
        a, b = args[ab[0]], args[ab[1]]
        nbytes = a.shape[0] * b.shape[1] * a.element_size()
        for sink in KEPT_SINKS:
            sink([], nbytes)
    return _checkpoint.CheckpointPolicy.MUST_SAVE


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` run under the policy ``remat`` (the reference's
    ``_maybe_remat``): as it is for 'none' or outside grad mode, else
    under a non-reentrant checkpoint.  No layer of a train path draws
    random numbers, so the RNG state is not stashed (reading the CUDA
    generator's state would not be legal inside a graph capture)."""
    if remat == "none":
        return fn
    context_fn = (functools.partial(
        _checkpoint.create_selective_checkpoint_contexts, _dots_policy)
        if remat == "dots" else _checkpoint.noop_context_fn)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        for sink in KEPT_SINKS:
            sink([t for t in tree_leaves(list(args))
                  if isinstance(t, Tensor)], 0)
        return _checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                      preserve_rng_state=False,
                                      context_fn=context_fn)

    return run


def _run_repeat(x: Tensor, aux: Tensor, rows, positions: Tensor,
                enc: Optional[Tensor], *, unit, cfg: ModelConfig,
                causal: bool, tp=None, sequence_parallel: bool = False,
                ep=None) -> Tuple[Tensor, Tensor]:
    """One repeat of a group's unit (the reference's scan body): ``rows``
    holds each layer's parameters; returns the (x, aux) carry."""
    for u in range(len(unit)):
        x, a = _apply_layer(x, rows[u], unit[u], cfg, positions, enc, causal,
                            tp, sequence_parallel, ep)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_group_train(x: Tensor, aux: Tensor, gparams, unit,
                     cfg: ModelConfig, positions: Tensor,
                     enc: Optional[Tensor] = None, causal: bool = True,
                     remat: str = "none", tp=None,
                     sequence_parallel: bool = False, ep=None
                     ) -> Tuple[Tensor, Tensor]:
    """Every repeat of a group in turn under the policy ``remat``; ``tp``,
    ``sequence_parallel`` and ``ep`` as :func:`_apply_layer`'s (a
    recomputed repeat runs its joins and exchanges again)."""
    count = tree_leaves(gparams)[0].shape[0]
    per_unit = [_unbind(up, count) for up in gparams]
    body = _maybe_remat(functools.partial(
        _run_repeat, unit=unit, cfg=cfg, causal=causal, tp=tp,
        sequence_parallel=sequence_parallel, ep=ep), remat)
    for r in range(count):
        x, aux = body(x, aux, [rows[r] for rows in per_unit], positions, enc)
    return x, aux


def _split_group(gparams, n_frozen_units: int):
    frozen = [_rows(up, 0, n_frozen_units) for up in gparams]
    live = [_rows(up, n_frozen_units, None) for up in gparams]
    return frozen, live


def _run_frozen(x: Tensor, aux: Tensor, gparams, unit, cfg, positions,
                enc: Optional[Tensor] = None, causal: bool = True, ep=None
                ) -> Tuple[Tensor, Tensor]:
    """The frozen layers under ``no_grad``: their aux still counts in the
    loss, as a value with no graph (the reference's ``stop_gradient``);
    the encoder output ``enc`` is a value there too."""
    with torch.no_grad():
        return _run_group_train(x.detach(), aux.detach(), gparams, unit, cfg,
                                positions, enc, causal, ep=ep)


def _frozen_units(cfg: ModelConfig, boundary: int, base: int) -> List[int]:
    """Per group of a stack whose first layer is flat layer ``base`` of the
    combined stack: how many of its repeats lie below ``boundary``."""
    out, off = [], base
    for unit, count in layer_groups(cfg):
        lo = off
        off += len(unit) * count
        out.append(min(count, max(0, (boundary - lo) // len(unit))))
    return out


def frozen_units(cfg: ModelConfig, bwd_layers: Optional[int] = None
                 ) -> Dict[str, List[int]]:
    """Per group of the decoder's stack (``"groups"``) and of an
    encoder-decoder's encoder (``"enc"``): how many of its repeats the
    suffix depth ``bwd_layers`` freezes, i.e. the leading rows of each
    stacked leaf whose gradient is zero (all of them: no gradient)."""
    boundary = total_layers(cfg) - _depth(cfg, bwd_layers)
    out = {"groups": _frozen_units(cfg, boundary, cfg.enc_layers)}
    if cfg.enc_layers:
        out["enc"] = _frozen_units(_encoder_cfg(cfg), boundary, 0)
    return out


def _run_stack(x: Tensor, aux: Tensor, groups, cfg: ModelConfig,
               positions: Tensor, boundary: int, base: int = 0,
               enc: Optional[Tensor] = None, causal: bool = True,
               remat: str = "none", ep=None) -> Tuple[Tensor, Tensor]:
    """Run all groups of a stack whose first layer is flat layer ``base``
    of the combined stack, freezing flat layers < boundary; the live
    repeats run under the policy ``remat``; ``ep`` as
    :func:`_apply_layer`'s."""
    for (unit, count), gparams, q in zip(layer_groups(cfg), groups,
                                         _frozen_units(cfg, boundary, base)):
        args = (unit, cfg, positions, enc, causal)
        if q == count:              # fully frozen group
            x, aux = _run_frozen(x, aux, gparams, *args, ep=ep)
        elif q == 0:                # fully differentiable
            x, aux = _run_group_train(x, aux, gparams, *args, remat, ep=ep)
        else:                       # split at a unit boundary
            frozen, live = _split_group(gparams, q)
            x, aux = _run_frozen(x, aux, frozen, *args, ep=ep)
            x, aux = _run_group_train(x, aux, live, *args, remat, ep=ep)
    return x, aux


def _encode(enc_params: Params, frames: Tensor, cfg: ModelConfig,
            boundary: int = 0, remat: str = "none") -> Tensor:
    """The bidirectional encoder (flat layers [0, enc_layers), frozen below
    ``boundary``) and its final norm: the decoder's cross-attention
    input."""
    ecfg = _encoder_cfg(cfg)
    with record_function(ENCODER_RANGE):
        x = frames.to(_dtype(cfg))
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE
        x, _ = _run_stack(x, aux, enc_params["groups"], ecfg, positions,
                          boundary, causal=False, remat=remat)
        return L.rms_norm(x, enc_params["final_norm"], cfg.norm_eps)


def _decoder_input(params: Params, batch: Dict[str, Tensor],
                   cfg: ModelConfig) -> Tensor:
    """The token embeddings, after the frontend's embeddings if the batch
    holds them."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend and "frontend" in batch:
        x = torch.cat([batch["frontend"].to(x.dtype), x], dim=1)
    return x


def forward_train(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                  *, bwd_layers: Optional[int] = None,
                  remat: Optional[str] = None, ep=None
                  ) -> Tuple[Tensor, Tensor]:
    """Returns (logits, moe_aux).  ``batch``: tokens (B, S_text), plus
    ``frames`` (B, T, d_model) for an encoder-decoder or ``frontend``
    (B, frontend_tokens, d_model) for a frontend config; the logits cover
    the text positions.  ``bwd_layers`` = SPB suffix depth over the
    combined stack (None = full backprop); ``remat`` the recompute policy
    of the live repeats (None: :data:`REMAT`); ``ep`` the model group a MoE
    layer's experts are sharded over (expert parallelism; None: one
    rank holds them all)."""
    _check_supported(cfg)
    remat = resolve_remat(remat)
    boundary = total_layers(cfg) - _depth(cfg, bwd_layers)
    enc = None
    if cfg.enc_layers:
        enc = _encode(params["enc"], batch["frames"], cfg, boundary, remat)
    # the decoder's input gets no gradient once a decoder layer is frozen
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and boundary <= cfg.enc_layers):
        x = _decoder_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _run_stack(x, aux, params["groups"], cfg, positions, boundary,
                        cfg.enc_layers, enc, remat=remat, ep=ep)
    return _logits(params, x, batch, cfg), aux


def _depth(cfg: ModelConfig, bwd_layers: Optional[int]) -> int:
    return total_layers(cfg) if bwd_layers is None else bwd_layers


def _logits(params: Params, x: Tensor, batch: Dict[str, Tensor],
            cfg: ModelConfig) -> Tensor:
    """The final norm and the unembedding of the text positions."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    x = x[:, -batch["tokens"].shape[1]:]        # the text, after a frontend
    return L.unembed(params["embed"], x, cfg)


def _loss(logits: Tensor, aux: Tensor, batch: Dict[str, Tensor],
          cfg: ModelConfig, aux_weight: float
          ) -> Tuple[Tensor, Dict[str, Tensor]]:
    xent = L.softmax_xent(logits, batch["labels"], valid_vocab=cfg.vocab_size)
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def loss_fn(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            bwd_layers: Optional[int] = None, aux_weight: float = 0.01,
            remat: Optional[str] = None, ep=None
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = forward_train(params, batch, cfg, bwd_layers=bwd_layers,
                                remat=remat, ep=ep)
    return _loss(logits, aux, batch, cfg, aux_weight)


# ---------------------------------------------------------------------------
# The recompute as a sweep (the functional steps under torch.func)
# ---------------------------------------------------------------------------

# the calls a 'dots' sweep keeps: ``x @ W`` with W a matrix and x of
# two dims or more, which the eager step dispatches as ``aten.mm`` (the
# live weight requires grad, so matmul always folds x's leading dims)
_MATMULS = (torch.matmul, Tensor.matmul, Tensor.__matmul__)


def _is_dot(func, args) -> bool:
    return (func in _MATMULS and len(args) == 2
            and isinstance(args[0], Tensor) and isinstance(args[1], Tensor)
            and args[0].dim() >= 2 and args[1].dim() == 2)


def _physical_numel(t: Tensor) -> int:
    """The elements ``t`` holds under ``torch.func.vmap``: a batched
    tensor's unwrapped (J, ...) value at every level, so a fused step's
    kept bytes count its J jobs."""
    from torch._C import _functorch
    while _functorch.is_batchedtensor(t):
        t = _functorch.get_unwrapped(t)
    return t.numel()


class _KeptProduct(torch.autograd.Function):
    """``a @ b`` whose value ``out`` was kept in the forward: returns it
    and pulls the cotangent back as the product's (the mm backward of a
    folded ``a``).  ``vmap`` runs the rule it generates."""
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, out):
        return out.view_as(out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, _ = inputs
        ctx.save_for_backward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g2 @ b.mT).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            gb = a.reshape(-1, a.shape[-1]).mT @ g2
        return ga, gb, None


class _DotsTape(TorchFunctionMode):
    """The 'dots' policy of a sweep (:func:`swept_grads`), which a
    checkpoint's dispatch hooks cannot give under ``torch.func``: while a
    live repeat's forward runs under it, each product :func:`_is_dot`
    picks is kept in ``kept`` in call order (its bytes reported to
    :data:`KEPT_SINKS`); while the repeat's ``torch.func.vjp`` recompute
    runs under it with ``replay``, each such call returns the kept output
    in place of the product (:class:`_KeptProduct`), its inputs still
    recomputed.  A function mode sees the calls as the model makes them,
    above ``vmap``'s batching (a dispatch mode there sees a batched mm as
    the bmm it becomes).  A replay whose call, shape or count differs
    from the record raises."""

    def __init__(self, kept: list, replay: bool = False):
        super().__init__()
        self.kept, self.replay, self.at = kept, replay, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _is_dot(func, args):
            return func(*args, **kwargs)
        a, b = args
        if not self.replay:
            out = func(a, b, **kwargs)
            self.kept.append((func, out))
            nbytes = _physical_numel(out) * out.element_size()
            for sink in KEPT_SINKS:
                sink([], nbytes)
            return out
        if self.at >= len(self.kept):
            raise RuntimeError(
                f"dots replay: product {self.at + 1} of a repeat that kept "
                f"{len(self.kept)}")
        kfunc, out = self.kept[self.at]
        shape = tuple(a.shape[:-1]) + (b.shape[-1],)
        if kfunc is not func or tuple(out.shape) != shape:
            raise RuntimeError(
                f"dots replay: product {self.at + 1} is {func.__name__} "
                f"to {shape}, but the record kept {kfunc.__name__} to "
                f"{tuple(out.shape)}")
        self.at += 1
        return _KeptProduct.apply(a, b, out)

    def finish(self) -> None:
        if self.at != len(self.kept):
            raise RuntimeError(
                f"dots replay: the recompute ran {self.at} products, the "
                f"record kept {len(self.kept)}")


def _sweep_forward(x: Tensor, aux: Tensor, groups, cfg: ModelConfig,
                   positions: Tensor, boundary: int, base: int,
                   enc: Optional[Tensor], causal: bool, dots: bool = False):
    """A stack's forward under ``no_grad``; returns (x, aux, tape), the
    tape holding (group, repeat, x, aux, kept) at the input of each live
    repeat, in order: ``kept`` the repeat's product outputs under
    ``dots`` (:class:`_DotsTape`), else None."""
    tape = []
    for g, ((unit, count), gparams, q) in enumerate(zip(
            layer_groups(cfg), groups, _frozen_units(cfg, boundary, base))):
        if q:
            frozen = [_rows(up, 0, q) for up in gparams]
            x, aux = _run_group_train(x, aux, frozen, unit, cfg, positions,
                                      enc, causal)
        for r in range(q, count):
            kept = [] if dots else None
            tape.append((g, r, x, aux, kept))
            with _DotsTape(kept) if dots else contextlib.nullcontext():
                x, aux = _run_repeat(x, aux,
                                     [_select(up, r) for up in gparams],
                                     positions, enc, unit=unit, cfg=cfg,
                                     causal=causal)
    return x, aux, tape


def _sweep_backward(gx: Tensor, gaux: Tensor, tape, groups, cfg: ModelConfig,
                    positions: Tensor, enc: Optional[Tensor], causal: bool,
                    x_needs_grad: bool):
    """The tape's repeats, last first: each recomputed under
    ``torch.func.vjp`` from its carry and pulled back.  Returns (the
    cotangent of the stack's input, or None when it needs none; the
    summed cotangent of ``enc``, or None; {(group, repeat): the row
    gradients of each layer of the unit})."""
    rows_grads, genc = {}, None
    units = [unit for unit, _ in layer_groups(cfg)]
    for i in range(len(tape) - 1, -1, -1):
        g, r, x_in, aux_in, kept = tape[i]
        unit = units[g]
        grad_x = i > 0 or x_needs_grad
        grad_enc = enc is not None and any(m == "xdec" for m, _ in unit)

        def repeat(rows, *rest, x_in=x_in, aux_in=aux_in, unit=unit,
                   grad_x=grad_x, grad_enc=grad_enc):
            rest = list(rest)
            x = rest.pop(0) if grad_x else x_in
            e = rest.pop(0) if grad_enc else enc
            return _run_repeat(x, aux_in, rows, positions, e, unit=unit,
                               cfg=cfg, causal=causal)

        primals = ([x_in] if grad_x else []) + ([enc] if grad_enc else [])
        with contextlib.nullcontext() if kept is None else \
                _DotsTape(kept, replay=True) as replay:
            _, pull = torch.func.vjp(
                repeat, [_select(up, r) for up in groups[g]], *primals)
        if replay is not None:
            replay.finish()
        tape[i] = None      # its carry and kept outputs go with the pull
        with torch.no_grad():
            cot = list(pull((gx, gaux), retain_graph=False))
        rows_grads[(g, r)] = cot.pop(0)
        gx = cot.pop(0) if grad_x else None
        if grad_enc:
            e = cot.pop(0)
            genc = e if genc is None else genc + e
    return gx, genc, rows_grads


def _stack_grads(groups, cfg: ModelConfig, rows_grads) -> list:
    """The stacked groups' gradients: each live row's from the sweep,
    zeros in the frozen rows."""
    out = []
    for g, ((unit, count), gparams) in enumerate(zip(layer_groups(cfg),
                                                     groups)):
        live = [r for r in range(count) if (g, r) in rows_grads]
        q = count - len(live)
        grads = []
        for u, up in enumerate(gparams):
            def leaf(t, *rows):
                parts = [torch.zeros_like(t[:q])] if q else []
                if rows:
                    parts.append(torch.stack(rows))
                return torch.cat(parts) if len(parts) > 1 else parts[0]
            grads.append(tree_map(leaf, up, *[rows_grads[(g, r)][u]
                                             for r in live]))
        out.append(grads)
    return out


def swept_grads(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                *, bwd_layers: Optional[int] = None, aux_weight: float = 0.01,
                remat: str = "full") -> Tuple[Params, Dict[str, Tensor]]:
    """The gradient of :func:`loss_fn` under the recompute ``remat``
    ('full' or 'dots'), in a form ``torch.func.vmap`` can batch (a
    checkpoint's saved-tensor hooks cannot run under ``torch.func``): the
    forward runs under ``no_grad``, keeping the (x, aux) carry at each
    live repeat, and under 'dots' its product outputs
    (:class:`_DotsTape`); then a ``torch.func.vjp`` of the head (final
    norm, unembedding, loss), of each live repeat, last first,
    recomputing it (the kept products replayed), of the encoder's final
    norm and live repeats, whose output's cotangent sums over the live
    decoder layers, and of the embedding last.  A frozen leaf's gradient
    is zeros.  Returns (grads, the metrics of :func:`loss_fn`)."""
    _check_supported(cfg)
    if remat not in ("full", "dots"):
        raise ValueError(f"swept_grads recomputes under 'full' or 'dots', "
                         f"not {remat!r}")
    dots = remat == "dots"
    boundary = total_layers(cfg) - _depth(cfg, bwd_layers)
    grads: Params = {}
    with torch.no_grad():
        enc = None
        if cfg.enc_layers:
            ecfg = _encoder_cfg(cfg)
            frames = batch["frames"].to(_dtype(cfg))
            enc_pos = torch.arange(frames.shape[1], device=frames.device)
            zero = torch.zeros((), dtype=torch.float32, device=frames.device)
            enc_x, _, enc_tape = _sweep_forward(
                frames, zero, params["enc"]["groups"], ecfg, enc_pos,
                boundary, 0, None, False, dots)
            enc = L.rms_norm(enc_x, params["enc"]["final_norm"],
                             cfg.norm_eps)
        x = _decoder_input(params, batch, cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, aux, tape = _sweep_forward(x, aux, params["groups"], cfg,
                                      positions, boundary, cfg.enc_layers,
                                      enc, True, dots)

    def head(final_norm, embed, x):
        p = {"final_norm": final_norm, "embed": embed}
        return _loss(_logits(p, x, batch, cfg), aux, batch, cfg, aux_weight)

    loss, pull, metrics = torch.func.vjp(head, params["final_norm"],
                                         params["embed"], x, has_aux=True)
    with torch.no_grad():
        grads["final_norm"], grads["embed"], gx = pull(
            torch.ones_like(loss), retain_graph=False)
    gaux = torch.full_like(aux, aux_weight)
    dec_input_grad = boundary <= cfg.enc_layers
    gx, genc, rows = _sweep_backward(gx, gaux, tape, params["groups"], cfg,
                                     positions, enc, True, dec_input_grad)
    grads["groups"] = _stack_grads(params["groups"], cfg, rows)
    if dec_input_grad:
        _, pull = torch.func.vjp(
            lambda embed: _decoder_input({"embed": embed}, batch, cfg),
            params["embed"])
        with torch.no_grad():
            (ge,) = pull(gx, retain_graph=False)
            grads["embed"] = tree_map(torch.add, grads["embed"], ge)
    if cfg.enc_layers:
        ep = params["enc"]
        grad_x = bool(enc_tape)
        _, pull = torch.func.vjp(
            lambda w, *xs: L.rms_norm(xs[0] if xs else enc_x, w,
                                      cfg.norm_eps),
            ep["final_norm"], *([enc_x] if grad_x else []))
        with torch.no_grad():
            cot = pull(torch.zeros_like(enc) if genc is None else genc,
                       retain_graph=False)
        rows = {}
        if grad_x:
            _, _, rows = _sweep_backward(cot[1], torch.zeros_like(aux),
                                         enc_tape, ep["groups"], ecfg,
                                         enc_pos, None, False, False)
        grads["enc"] = {"groups": _stack_grads(ep["groups"], ecfg, rows),
                        "final_norm": cot[0]}
    return {k: grads[k] for k in params}, metrics


# ---------------------------------------------------------------------------
# KV cache: init / prefill / decode
# ---------------------------------------------------------------------------

def _init_layer_cache(kinds, cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype: torch.dtype, device) -> Params:
    mixer, _ = kinds
    if mixer == "xdec":
        cross = (batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        return {"self": L.init_attention_cache(cfg, batch, max_len, "attn",
                                               dtype, device),
                "cross": {k: torch.zeros(cross, dtype=dtype, device=device)
                          for k in ("k", "v")}}
    if mixer in ("attn", "local"):
        c = L.init_attention_cache(cfg, batch, max_len, mixer, dtype, device)
    elif mixer == "mla":
        c = L.init_mla_cache(cfg, batch, max_len, dtype, device)
    elif mixer == "ssd":
        c = S.init_mamba2_cache(cfg, batch, dtype, device)
    elif mixer == "rglru":
        c = S.init_rglru_cache(cfg, batch, dtype, device)
    else:
        raise ValueError(mixer)
    return {"self": c}


def stacked_zeros(tree: Params, count: int, device) -> Params:
    """Zeros shaped as the (meta) ``tree`` with a leading ``count`` dim:
    one group's cache, laid out as the group's stacked parameters."""
    return {k: stacked_zeros(v, count, device) if isinstance(v, dict) else
            torch.zeros((count,) + tuple(v.shape), dtype=v.dtype,
                        device=device) for k, v in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device=None) -> Params:
    """The dense per-slot caches, grouped like the params: each leaf has a
    leading ``count`` dim; an ``xdec`` layer's ``cross`` k, v hold the
    ``enc_len`` encoder positions.  ``pos`` (a 0-dim int64 tensor) is the
    next position to decode."""
    _check_supported(cfg)
    dtype = _dtype(cfg)
    groups = [[stacked_zeros(_init_layer_cache(kinds, cfg, batch, max_len,
                                               enc_len, dtype, "meta"),
                             count, device)
               for kinds in unit] for unit, count in layer_groups(cfg)]
    return {"groups": groups,
            "pos": torch.zeros((), dtype=torch.int64, device=device)}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: int = 0) -> Params:
    """:func:`init_cache` as meta tensors (``jax.eval_shape`` of it)."""
    return init_cache(cfg, batch, max_len, enc_len, device="meta")


def _select(tree: Params, r: int) -> Params:
    """Row ``r`` of every stacked leaf, as views (in-place writes reach
    the stacked tensor)."""
    return {k: _select(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _run_group_cached(x: Tensor, gparams, gcache, unit, cfg: ModelConfig,
                      mode: str, kw: Dict[str, Any],
                      enc: Optional[Tensor], tp=None,
                      whole: frozenset = frozenset()) -> Tensor:
    count = tree_leaves(gparams)[0].shape[0]
    per_unit = [_unbind(up, count) for up in gparams]
    for r in range(count):
        for u in range(len(unit)):
            x = _apply_layer_cached(x, per_unit[u][r], unit[u], cfg,
                                    _select(gcache[u], r), mode, kw, enc, tp,
                                    whole)
    return x


def _run_cached(x: Tensor, params: Params, groups, cfg: ModelConfig,
                mode: str, kw: Dict[str, Any],
                enc: Optional[Tensor] = None, tp=None,
                whole: frozenset = frozenset()) -> Tensor:
    for (unit, _), gp, gc in zip(layer_groups(cfg), params["groups"], groups):
        x = _run_group_cached(x, gp, gc, unit, cfg, mode, kw, enc, tp, whole)
    return x


@torch.no_grad()
def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params, *, tp=None) -> Tuple[Tensor, Params]:
    """Fill the cache from a prompt; returns (last-token logits (B, 1, V),
    cache).  ``batch`` as :func:`forward_train`'s: an encoder-decoder's
    ``frames`` run through the encoder into the ``cross`` caches; a
    frontend's embeddings come before the tokens and take the first
    positions.  ``tp``: the serving grid's model group
    (:func:`_apply_layer_cached`): params and cache are then this rank's
    shards (``dist/steps.shard_decode_step``), and the logits whole on
    every model rank."""
    _check_supported(cfg)
    enc = _encode(params["enc"], batch["frames"], cfg) if cfg.enc_layers \
        else None
    x = _decoder_input(params, batch, cfg)
    S_ = x.shape[1]
    x = _run_cached(x, params, cache["groups"], cfg, "prefill",
                    {"positions": torch.arange(S_, device=x.device)}, enc, tp)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    pos = torch.full((), S_, dtype=torch.int64, device=x.device)
    return L.unembed(params["embed"], x, cfg), {"groups": cache["groups"],
                                                 "pos": pos}


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: Tensor,
                cfg: ModelConfig, *, tp=None, seq=None,
                whole: frozenset = frozenset()) -> Tuple[Tensor, Params]:
    """One-token decode.  tokens: (B, 1).  The position is cache['pos'];
    ``tp`` as :func:`prefill`'s (a MoE layer under ``impl="ep"`` at
    B < 4 T takes ``moe_fwd_ep``'s small path).  ``seq`` (a
    ``dist/group.SeqGroup``): the caches whose sequence the ``kv_seq``
    rule shards -- an attn/local/xdec layer's k and v, an MLA layer's
    latents -- hold this rank's share of it, and those mixers attend
    their share and combine across the ranks (``models/layers.
    seq_combine``); an SSD or RG-LRU state is whole.  ``whole``: the
    layer kinds run whole despite ``tp`` (:func:`_apply_layer_cached`)."""
    _check_supported(cfg)
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens, cfg)
    kw = {"pos": pos} if seq is None else {"pos": pos, "seq": seq}
    x = _run_cached(x, params, cache["groups"], cfg, "decode", kw, tp=tp,
                    whole=whole)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), {"groups": cache["groups"],
                                                 "pos": pos + 1}


# ---------------------------------------------------------------------------
# Serving: paged-cache prefill / slot-batched decode (repro_torch.serve)
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve_prefill(params: Params, tokens: Tensor, cfg: ModelConfig,
                  cache_groups, *, page_row: Tensor, prompt_len: Tensor,
                  tp=None) -> Tuple[Tensor, Any]:
    """Prefill ONE slot of a paged cache from a right-padded prompt.

    tokens: (1, bucket) with the real prompt in the first ``prompt_len``
    positions (a (1,) int64 device tensor: one code path serves every
    prompt up to the bucket length).  ``page_row``: the slot's (Pmax,)
    physical page list.  Returns (logits (1, V) at position prompt_len - 1,
    the cache groups, updated in place).  Pad positions are computed but
    masked everywhere it matters: causal attention keeps them out of real
    positions' context, and their K/V goes to the trash page.  ``tp``: the
    serving grid's model group (:func:`_apply_layer_cached`); params and
    pool are then this rank's shares, the logits whole.
    """
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_cached(x, params, cache_groups, cfg, "serve_prefill",
                    {"positions": positions, "page_row": page_row,
                     "valid_len": prompt_len}, tp=tp)
    x_last = x.index_select(1, prompt_len.reshape(1) - 1)         # (1, 1, D)
    x_last = L.rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x_last, cfg)[:, 0], cache_groups


@torch.no_grad()
def serve_decode(params: Params, cache_groups, tokens: Tensor,
                 cfg: ModelConfig, *, pos: Tensor, page_table: Tensor,
                 active: Tensor, tp=None) -> Tuple[Tensor, Any]:
    """One slot-batched decode step over a paged cache.

    tokens: (N, 1) last emitted token per slot; pos: (N,) absolute write
    position per slot; page_table: (N, Pmax); active: (N,) bool.  Every
    slot computes (the batch shape is fixed, so requests come and go
    without a new shape); inactive slots write only to the trash page and
    their logits are discarded by the engine.  Returns (logits (N, V), the
    cache groups, updated in place).  ``tp`` as :func:`serve_prefill`'s.
    """
    x = L.embed(params["embed"], tokens, cfg)
    x = _run_cached(x, params, cache_groups, cfg, "serve_decode",
                    {"pos": pos, "page_table": page_table, "active": active},
                    tp=tp)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache_groups
