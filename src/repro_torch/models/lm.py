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
order into the loss; the frozen layers' part carries no graph.  The
port keeps every live activation (the JAX ``REMAT="full"`` recomputes
instead; it changes no numbers).

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

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.config import ModelConfig, layer_groups, total_layers
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.tree import tree_leaves

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


def init_lm(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` (on ``gen``'s device).  The
    layout and leaf dtypes equal ``repro.models.lm.init_lm``'s; the numbers
    differ."""

    def init(tree, name):
        if isinstance(tree, dict):
            return {k: init(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [init(v, name) for v in tree]
        return _init_leaf(gen, name, tree, device)

    return init(param_shapes(cfg), "")


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


def _apply_ffn(x: Tensor, up: Params, ffn: str, cfg: ModelConfig
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """The FFN half of a layer: (x, the layer's MoE aux, or None for a
    dense FFN or none)."""
    aux = None
    if cfg.d_ff > 0:
        h = L.rms_norm(x, up["ln2"], cfg.norm_eps)
        if ffn == "moe":
            out, aux = M.moe_fwd(up["ffn"], h, cfg)
        else:
            out = L.ffn_fwd(up["ffn"], h)
        x = x + out
    return x, aux


def _apply_layer(x: Tensor, up: Params, kinds, cfg: ModelConfig,
                 positions: Tensor, enc: Optional[Tensor] = None,
                 causal: bool = True) -> Tuple[Tensor, Optional[Tensor]]:
    """Returns (x, the layer's MoE aux, or None for a dense FFN).  ``enc``:
    the encoder output an ``xdec`` layer cross-attends to; ``causal=False``:
    an encoder layer's bidirectional self-attention."""
    mixer, ffn = kinds
    h = L.rms_norm(x, up["ln1"], cfg.norm_eps)
    if mixer == "ssd":
        o = S.mamba2_fwd(up["mixer"], h, cfg)
    elif mixer == "rglru":
        o = S.rglru_fwd(up["mixer"], h, cfg)
    elif mixer == "mla":
        o = L.mla_fwd(up["mixer"], h, cfg, positions=positions)
    else:
        o = L.attention_fwd(up["mixer"], h, cfg, kind=mixer,
                            positions=positions, causal=causal)
    x = x + o
    if mixer == "xdec":
        hx = L.rms_norm(x, up["lnx"], cfg.norm_eps)
        x = x + L.cross_attention_fwd(up["xattn"], hx, enc, cfg)
    return _apply_ffn(x, up, ffn, cfg)


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


def _apply_layer_cached(x: Tensor, up: Params, kinds, cfg: ModelConfig,
                        cache: Params, mode: str, kw: Dict[str, Any],
                        enc: Optional[Tensor] = None) -> Tensor:
    """One layer of a cached mode; its cache is updated in place.  ``kw``:
    the mode's position arguments (``positions`` or ``pos``, plus the
    page table and the mask in the serve modes).  An ``xdec`` layer's
    prefill fills its ``cross`` cache from the encoder output ``enc``; its
    decode reads it."""
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
        o, _ = _ATTN[mode](up["mixer"], h, cfg, kind=mixer,
                           cache=cache["self"], **kw)
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
                                          (cross["k"], cross["v"]))
        x = x + xo
    return _apply_ffn(x, up, ffn, cfg)[0]


def _run_group_train(x: Tensor, aux: Tensor, gparams, unit,
                     cfg: ModelConfig, positions: Tensor,
                     enc: Optional[Tensor] = None, causal: bool = True
                     ) -> Tuple[Tensor, Tensor]:
    count = tree_leaves(gparams)[0].shape[0]
    per_unit = [_unbind(up, count) for up in gparams]
    for r in range(count):
        for u in range(len(unit)):
            x, a = _apply_layer(x, per_unit[u][r], unit[u], cfg, positions,
                                enc, causal)
            if a is not None:
                aux = aux + a
    return x, aux


def _split_group(gparams, n_frozen_units: int):
    frozen = [_rows(up, 0, n_frozen_units) for up in gparams]
    live = [_rows(up, n_frozen_units, None) for up in gparams]
    return frozen, live


def _run_frozen(x: Tensor, aux: Tensor, gparams, unit, cfg, positions,
                enc: Optional[Tensor] = None, causal: bool = True
                ) -> Tuple[Tensor, Tensor]:
    """The frozen layers under ``no_grad``: their aux still counts in the
    loss, as a value with no graph (the reference's ``stop_gradient``);
    the encoder output ``enc`` is a value there too."""
    with torch.no_grad():
        return _run_group_train(x.detach(), aux.detach(), gparams, unit, cfg,
                                positions, enc, causal)


def _run_stack(x: Tensor, aux: Tensor, groups, cfg: ModelConfig,
               positions: Tensor, boundary: int, base: int = 0,
               enc: Optional[Tensor] = None, causal: bool = True
               ) -> Tuple[Tensor, Tensor]:
    """Run all groups of a stack whose first layer is flat layer ``base``
    of the combined stack, freezing flat layers < boundary."""
    off = base
    for (unit, count), gparams in zip(layer_groups(cfg), groups):
        p = len(unit)
        lo, hi = off, off + p * count
        off = hi
        args = (unit, cfg, positions, enc, causal)
        if boundary >= hi:          # fully frozen group
            x, aux = _run_frozen(x, aux, gparams, *args)
        elif boundary <= lo:        # fully differentiable
            x, aux = _run_group_train(x, aux, gparams, *args)
        else:                       # split at a unit boundary
            frozen, live = _split_group(gparams, (boundary - lo) // p)
            x, aux = _run_frozen(x, aux, frozen, *args)
            x, aux = _run_group_train(x, aux, live, *args)
    return x, aux


def _encode(enc_params: Params, frames: Tensor, cfg: ModelConfig,
            boundary: int = 0) -> Tensor:
    """The bidirectional encoder (flat layers [0, enc_layers), frozen below
    ``boundary``) and its final norm: the decoder's cross-attention
    input."""
    ecfg = _encoder_cfg(cfg)
    with record_function(ENCODER_RANGE):
        x = frames.to(_dtype(cfg))
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)  # no MoE
        x, _ = _run_stack(x, aux, enc_params["groups"], ecfg, positions,
                          boundary, causal=False)
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
                  *, bwd_layers: Optional[int] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Returns (logits, moe_aux).  ``batch``: tokens (B, S_text), plus
    ``frames`` (B, T, d_model) for an encoder-decoder or ``frontend``
    (B, frontend_tokens, d_model) for a frontend config; the logits cover
    the text positions.  ``bwd_layers`` = SPB suffix depth over the
    combined stack (None = full backprop)."""
    _check_supported(cfg)
    total = total_layers(cfg)
    depth = total if bwd_layers is None else bwd_layers
    boundary = total - depth
    enc = None
    if cfg.enc_layers:
        enc = _encode(params["enc"], batch["frames"], cfg, boundary)
    # the decoder's input gets no gradient once a decoder layer is frozen
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and boundary <= cfg.enc_layers):
        x = _decoder_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _run_stack(x, aux, params["groups"], cfg, positions, boundary,
                        cfg.enc_layers, enc)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    x = x[:, -batch["tokens"].shape[1]:]        # the text, after a frontend
    return L.unembed(params["embed"], x, cfg), aux


def loss_fn(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig, *,
            bwd_layers: Optional[int] = None, aux_weight: float = 0.01
            ) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = forward_train(params, batch, cfg, bwd_layers=bwd_layers)
    xent = L.softmax_xent(logits, batch["labels"], valid_vocab=cfg.vocab_size)
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


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
                      enc: Optional[Tensor]) -> Tensor:
    count = tree_leaves(gparams)[0].shape[0]
    per_unit = [_unbind(up, count) for up in gparams]
    for r in range(count):
        for u in range(len(unit)):
            x = _apply_layer_cached(x, per_unit[u][r], unit[u], cfg,
                                    _select(gcache[u], r), mode, kw, enc)
    return x


def _run_cached(x: Tensor, params: Params, groups, cfg: ModelConfig,
                mode: str, kw: Dict[str, Any],
                enc: Optional[Tensor] = None) -> Tensor:
    for (unit, _), gp, gc in zip(layer_groups(cfg), params["groups"], groups):
        x = _run_group_cached(x, gp, gc, unit, cfg, mode, kw, enc)
    return x


@torch.no_grad()
def prefill(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
            cache: Params) -> Tuple[Tensor, Params]:
    """Fill the cache from a prompt; returns (last-token logits (B, 1, V),
    cache).  ``batch`` as :func:`forward_train`'s: an encoder-decoder's
    ``frames`` run through the encoder into the ``cross`` caches; a
    frontend's embeddings come before the tokens and take the first
    positions."""
    _check_supported(cfg)
    enc = _encode(params["enc"], batch["frames"], cfg) if cfg.enc_layers \
        else None
    x = _decoder_input(params, batch, cfg)
    S_ = x.shape[1]
    x = _run_cached(x, params, cache["groups"], cfg, "prefill",
                    {"positions": torch.arange(S_, device=x.device)}, enc)
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    pos = torch.full((), S_, dtype=torch.int64, device=x.device)
    return L.unembed(params["embed"], x, cfg), {"groups": cache["groups"],
                                                 "pos": pos}


@torch.no_grad()
def decode_step(params: Params, cache: Params, tokens: Tensor,
                cfg: ModelConfig) -> Tuple[Tensor, Params]:
    """One-token decode.  tokens: (B, 1).  The position is cache['pos']."""
    _check_supported(cfg)
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens, cfg)
    x = _run_cached(x, params, cache["groups"], cfg, "decode", {"pos": pos})
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg), {"groups": cache["groups"],
                                                 "pos": pos + 1}


# ---------------------------------------------------------------------------
# Serving: paged-cache prefill / slot-batched decode (repro_torch.serve)
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve_prefill(params: Params, tokens: Tensor, cfg: ModelConfig,
                  cache_groups, *, page_row: Tensor, prompt_len: Tensor
                  ) -> Tuple[Tensor, Any]:
    """Prefill ONE slot of a paged cache from a right-padded prompt.

    tokens: (1, bucket) with the real prompt in the first ``prompt_len``
    positions (a (1,) int64 device tensor: one code path serves every
    prompt up to the bucket length).  ``page_row``: the slot's (Pmax,)
    physical page list.  Returns (logits (1, V) at position prompt_len - 1,
    the cache groups, updated in place).  Pad positions are computed but
    masked everywhere it matters: causal attention keeps them out of real
    positions' context, and their K/V goes to the trash page.
    """
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_cached(x, params, cache_groups, cfg, "serve_prefill",
                    {"positions": positions, "page_row": page_row,
                     "valid_len": prompt_len})
    x_last = x.index_select(1, prompt_len.reshape(1) - 1)         # (1, 1, D)
    x_last = L.rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x_last, cfg)[:, 0], cache_groups


@torch.no_grad()
def serve_decode(params: Params, cache_groups, tokens: Tensor,
                 cfg: ModelConfig, *, pos: Tensor, page_table: Tensor,
                 active: Tensor) -> Tuple[Tensor, Any]:
    """One slot-batched decode step over a paged cache.

    tokens: (N, 1) last emitted token per slot; pos: (N,) absolute write
    position per slot; page_table: (N, Pmax); active: (N,) bool.  Every
    slot computes (the batch shape is fixed, so requests come and go
    without a new shape); inactive slots write only to the trash page and
    their logits are discarded by the engine.  Returns (logits (N, V), the
    cache groups, updated in place).
    """
    x = L.embed(params["embed"], tokens, cfg)
    x = _run_cached(x, params, cache_groups, cfg, "serve_decode",
                    {"pos": pos, "page_table": page_table, "active": active})
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache_groups
