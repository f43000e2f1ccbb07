"""Model layers of the port: norm, RoPE, embedding, SwiGLU FFN, GQA and
MLA attention (train, dense-cache prefill/decode and the serving engine's
paged prefill/decode), the encoder-decoder's cross-attention, the loss
(``repro/models/layers.py``), with the tensor-parallel collective pairs
of a pipeline's tensor-sharded stages.

Plain functions over parameter dictionaries of tensors, in the JAX
package's layouts, so the two packages can be fed the same weights.
Train and prefill attention run the hand-written kernels
(``repro_torch.kernels.ops``) when ``cfg.use_pallas`` is set: always on
the card, and on the CPU when the shapes tile as the JAX gate demands;
otherwise the plain blockwise path.  MLA's heads (qk dim dn + dr, v dim
dv) go to the kernels zero-padded to one dispatched head_dim with the
scale 1 / sqrt(dn + dr).  Bidirectional attention (an encoder's
self-attention, the decoder's cross-attention over the encoder output)
is plain blockwise attention, as the reference computes it outside its
kernels.  One-token decode attention has no kernel in
the reference either: it is plain PyTorch with f32 scores.  The cached
paths update their cache tensors in place and return them.  The large
projections are ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import pair_mask, padded_head_dim

Tensor = torch.Tensor
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm scaling by ``1 + w`` (the weight is stored as scale - 1),
    with f32 row statistics and the scale applied in the storage dtype:
    ``(x * scale) * (1 + w)``.  Autograd of this is the JAX custom VJP's
    math."""
    xf = x.float()
    ms = torch.einsum("...d,...d->...", xf, xf) / x.shape[-1]
    scale = torch.rsqrt(ms + eps)[..., None]
    return (x * scale.to(x.dtype)) * (1.0 + w).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Half-split rotary embedding in f32.  x: (..., S, H, D);
    positions: (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.float()[..., None] * freqs               # (S|B,S, D/2)
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention (the plain path)
# ---------------------------------------------------------------------------

def blockwise_attention(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_block: int = 1024, kv_block: int = 1024) -> Tensor:
    """Attention one q block at a time over the kv span it can see.
    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K*G.  f32 scores,
    probabilities in v's dtype, f32 accumulation (the JAX plain path's
    rounding points); each q block takes its whole span at once, which is
    the JAX kv loop's online softmax in exact arithmetic."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qv = q.reshape(B, Sq, K, G, D)
    q_block = min(q_block, Sq)
    outs = []
    for qs in range(0, Sq, q_block):
        qb = min(q_block, Sq - qs)
        lo = max(0, qs - window + 1) if window > 0 else 0
        hi = min(Sk, qs + qb) if causal else Sk
        mask = pair_mask(qb, hi - lo, causal, window, q.device,
                         q_start=qs, k_start=lo)
        s = torch.einsum("bqkgd,bskd->bkgqs", qv[:, qs:qs + qb].float(),
                         k[:, lo:hi].float()) * scale
        s = s + torch.where(mask, 0.0, -1e30)
        m = s.amax(dim=-1).clamp_min(-1e29)
        p = torch.exp(s - m[..., None]).to(v.dtype)
        l = p.float().sum(dim=-1)
        acc = torch.einsum("bkgqs,bskd->bkgqd", p.float(), v[:, lo:hi].float())
        out = acc / l[..., None].clamp_min(1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qb, H, v.shape[-1]))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (Megatron f/g + sequence-parallel transitions)
# ---------------------------------------------------------------------------
# Inside a tensor-sharded pipeline stage (``dist/pipeline/stage.py``) the
# attention and FFN weights are column/row-sharded over the stage's model
# group (``dist/group.ModelGroup``), so the row products give partial sums
# that are reduced explicitly.  Each Function pairs one forward collective
# of the group with its exact adjoint, as the reference's ``custom_vjp``s
# do; ``group`` is the ModelGroup and ``dim`` the sequence dim.  Expert
# parallelism (``models/moe.moe_fwd_ep``) uses the slice, the gather and
# the psum, plus its own exchange, the aux mean and the share below.

class _TPPsum(torch.autograd.Function):
    """All-reduce at a row-parallel join (Megatron 'g'): forward the sum;
    backward the identity (the output cotangent is already replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TPEnter(torch.autograd.Function):
    """Enter a column-parallel region (Megatron 'f'): forward the
    identity; backward the all-reduce (each shard's input cotangent is a
    partial sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class _SPAllGather(torch.autograd.Function):
    """Sequence-parallel block entry: gather the sequence shards; the
    adjoint reduce-scatters the cotangent back to its shard."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _SPReduceScatter(torch.autograd.Function):
    """Sequence-parallel block exit: reduce the row-parallel partial sums
    and keep this shard's slice of the sequence; the adjoint all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


def _shard_of(x: Tensor, group, dim: int) -> Tensor:
    size = x.shape[dim] // group.size
    return x.narrow(dim, group.rank * size, size).contiguous()


class _SPSlice(torch.autograd.Function):
    """Stage inlet under sequence parallelism: this shard's slice of the
    replicated input; the adjoint all-gathers (each position has one
    owner, so the gather reassembles the whole cotangent)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _shard_of(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


class _SPUnslice(torch.autograd.Function):
    """Stage outlet under sequence parallelism: all-gather the shards, so
    the activation that crosses to the next stage is whole; the adjoint
    takes this shard's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _shard_of(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """Expert parallelism's exchange of equal chunks along dim 0 over the
    model group (``ModelGroup.all_to_all``); the adjoint is the same
    exchange of the cotangent, back to where each chunk came from."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_to_all(g), None


class _ModelMean(torch.autograd.Function):
    """The mean over the model group of a value each rank computed from its
    own tokens (a MoE layer's aux loss, the reference's ``pmean``), whose
    consumer runs replicated on every rank: forward the all-reduce over T;
    backward the local ``g / T`` (each rank's copy of the loss stands for
    one loss, so the T copies of its cotangent are not summed)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = group.size
        return group.all_reduce(x) / group.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _ModelShare(torch.autograd.Function):
    """A value every rank of the model group computes alike, inside a
    region whose input cotangent is summed over the group (``tp_enter``):
    forward the identity; backward this rank's share ``g / T`` of the
    cotangent, so that the sum restores it once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.size = group.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def tp_psum(x: Tensor, group) -> Tensor:
    return _TPPsum.apply(x, group)


def ep_all_to_all(x: Tensor, group) -> Tensor:
    return _AllToAll.apply(x, group)


def model_mean(x: Tensor, group) -> Tensor:
    return _ModelMean.apply(x, group)


def model_share(x: Tensor, group) -> Tensor:
    return _ModelShare.apply(x, group)


def tp_enter(x: Tensor, group) -> Tensor:
    return _TPEnter.apply(x, group)


def sp_all_gather(x: Tensor, group, dim: int) -> Tensor:
    return _SPAllGather.apply(x, group, dim)


def sp_reduce_scatter(x: Tensor, group, dim: int) -> Tensor:
    return _SPReduceScatter.apply(x, group, dim)


def sp_slice(x: Tensor, group, dim: int) -> Tensor:
    return _SPSlice.apply(x, group, dim)


def sp_unslice(x: Tensor, group, dim: int) -> Tensor:
    return _SPUnslice.apply(x, group, dim)


def _tp_in(x: Tensor, tp, sequence_parallel: bool) -> Tensor:
    """A column-parallel block's input: the whole sequence under sequence
    parallelism, else ``x`` entered (``tp``: the model group or None)."""
    if tp is None:
        return x
    return sp_all_gather(x, tp, 1) if sequence_parallel else tp_enter(x, tp)


def _tp_out(y: Tensor, tp, sequence_parallel: bool) -> Tensor:
    """A row-parallel block's joined output: this shard's sequence slice
    of the sum under sequence parallelism, else the sum."""
    if tp is None:
        return y
    return sp_reduce_scatter(y, tp, 1) if sequence_parallel \
        else tp_psum(y, tp)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def _pallas_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int, scale: Optional[float] = None
                      ) -> Optional[Tensor]:
    """The hand-written kernels, or None for :func:`blockwise_attention`.

    A CUDA tensor always takes the kernels: they tile at 64 x 64 and mask
    ragged edges, and raise for a shape or dtype they do not take.  A CPU
    tensor keeps the JAX package's shape gate (S % min(128, S) == 0 and
    whole GQA groups), so the CPU path takes the same branch as the
    reference and agrees with it exactly."""
    Sq, Sk = q.shape[1], k.shape[1]
    qb, kb = min(128, Sq), min(128, Sk)
    if q.device.type == "cpu" and (Sq % qb or Sk % kb
                                   or q.shape[2] % k.shape[2]):
        return None
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_block=qb, kv_block=kb, scale=scale)


def _attend(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig,
            window: int) -> Tensor:
    """Causal train/prefill attention: the kernels under ``use_pallas``,
    else (or for a CPU shape they do not tile) the blockwise path."""
    o = None
    if cfg.use_pallas:
        o = _pallas_attention(q, k, v, causal=True, window=window)
    if o is None:
        o = blockwise_attention(q, k, v, causal=True, window=window,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
    return o


def _qkv(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """Roped q (B, S, H, Dh) and k, v (B, S, K, Dh); the head counts from
    the weights' widths."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    H, K = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, K, Dh)
    v = (x @ p["wv"]).reshape(B, S, K, Dh)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


def attention_fwd(p: Params, x: Tensor, cfg: ModelConfig, *, kind: str,
                  positions: Tensor, causal: bool = True, tp=None,
                  sequence_parallel: bool = False) -> Tensor:
    """Train self-attention.  x: (B, S, D).  ``causal=False`` is an
    encoder's: every position sees every other, on the blockwise path.

    ``tp`` (a ``dist/group.ModelGroup``): wq/wk/wv are column- and wo
    row-sharded over it, so the head counts are the local weights' and the
    output is joined by :func:`tp_psum`; ``sequence_parallel`` enters by
    :func:`sp_all_gather` and joins by :func:`sp_reduce_scatter`, so ``x``
    and the output are this shard's slice of the sequence."""
    x = _tp_in(x, tp, sequence_parallel)
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if causal:
        o = _attend(q, k, v, cfg, _window(cfg, kind))
    else:
        o = blockwise_attention(q, k, v, causal=False,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
    return _tp_out(o.reshape(B, S, -1) @ p["wo"], tp, sequence_parallel)


def _partial_softmax(s: Tensor):
    """``(w, m, l)`` of scores ``s`` (..., S) masked with -inf: ``w =
    exp(s - m) / l`` over the row, ``m`` its max and ``l`` its sum of
    ``exp(s - m)``.  A row with no valid position (a rank's share of the
    sequence early in a sequence or in a ring) gives ``w = 0``, ``m =
    -inf``, ``l = 0``, where ``torch.softmax`` would give NaN."""
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(-1)
    return p / torch.where(l > 0, l, 1.0)[..., None], m, l


def decode_attention(q: Tensor, k: Tensor, v: Tensor, kpos: Tensor,
                     qpos: Tensor, *, window: int = 0,
                     partial: bool = False):
    """Single-step decode attention over a (possibly ring-buffered) cache.

    q: (B, 1, H, D); k, v: (B, W, K, D); kpos: (B, W) absolute positions of
    the cache slots (negative or beyond ``qpos`` = masked to -inf); qpos:
    (B,) absolute query positions.  f32 scores and softmax, weights in v's
    dtype, f32 sums.

    ``partial``: k, v are one rank's share of a sequence-sharded cache;
    returns ``(o, m, l)``, the f32 output (B, 1, H, Dv) normalized over the
    share, the row max ``m`` (B, H) of the scores and the row sum ``l``
    (B, H) of ``exp(s - m)`` (:func:`_partial_softmax`), which
    :func:`seq_combine` joins across the ranks."""
    B, _, H, D = q.shape
    K = k.shape[2]
    qv = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bskd->bkgs", qv.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    mask = (kpos >= 0) & (kpos <= qpos[:, None])
    if window > 0:
        mask &= kpos > (qpos[:, None] - window)
    s = torch.where(mask[:, None, None], s, -math.inf)
    if partial:
        w, m, l = _partial_softmax(s)
    else:
        w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype).float(), v.float())
    out = out.reshape(B, 1, H, v.shape[-1])
    if partial:
        return out, m.reshape(B, H), l.reshape(B, H)
    return out.to(q.dtype)


def seq_combine(o: Tensor, m: Tensor, l: Tensor, seq) -> Tensor:
    """Join the ranks' partial attentions over their shares of the
    sequence (:func:`decode_attention`'s ``partial`` form): o (B, 1, H, Dv)
    f32, m and l (B, H).  One all-gather over ``seq`` (a
    ``dist/group.SeqGroup``) of the packed (B, H, Dv + 2) f32 parts, then
    on every rank, in the gather's order: ``M = max_r m_r``, ``c_r =
    exp(m_r - M) l_r`` and ``o = sum_r c_r o_r / sum_r c_r``, so the ranks
    stay bit-identical.  A share with no valid position (``m = -inf``,
    ``l = 0``, ``o = 0``) weighs ``exp(-inf) = 0``.  Returns the f32
    output (B, 1, H, Dv)."""
    B, _, H, Dv = o.shape
    packed = torch.cat([o.reshape(B, H, Dv), m[..., None], l[..., None]],
                       dim=-1)
    parts = seq.all_gather(packed[None], 0)          # (n, B, H, Dv + 2)
    po, pm, pl = parts[..., :Dv], parts[..., Dv], parts[..., Dv + 1]
    c = torch.exp(pm - pm.amax(0)) * pl
    out = (c[..., None] * po).sum(0) / c.sum(0)[..., None]
    return out.reshape(B, 1, H, Dv)


def _seq_write(buf: Tensor, slot: Tensor, value: Tensor, seq) -> None:
    """Write ``value`` (B, 1, ...) at slot ``slot`` ((1,) device tensor) of
    a cache whose dim 1 is sharded over ``seq``'s ranks in blocks, this
    rank holding block ``seq.rank``: the rank that owns the slot writes it;
    the others write back what they hold (no host sync decides)."""
    Ws = buf.shape[1]
    local = slot - seq.rank * Ws
    mine = ((local >= 0) & (local < Ws)).reshape((1,) * value.dim())
    idx = local.clamp(0, Ws - 1)
    buf.index_copy_(1, idx, torch.where(mine, value.to(buf.dtype),
                                        buf.index_select(1, idx)))


# ---------------------------------------------------------------------------
# GQA attention: dense per-slot caches (prefill / decode)
# ---------------------------------------------------------------------------

def attention_prefill(p: Params, x: Tensor, cfg: ModelConfig, *, kind: str,
                      positions: Tensor, cache: Params, tp=None):
    """Prefill: run attention and fill the layer cache in place.  A cache
    shorter than the prompt (a local layer's ring buffer of W slots) keeps
    the last W positions, position t in slot t mod W.

    ``tp`` (a ``dist/group.ModelGroup``), here and in the three cached
    functions below, as :func:`attention_fwd`'s: the weights are this
    rank's column/row shards, so the head counts are the local ones, the
    cache holds this rank's KV heads and the output is joined by
    :func:`tp_psum` (forward only: the cached modes run under
    ``no_grad``)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = _attend(q, k, v, cfg, _window(cfg, kind))
    W = cache["k"].shape[1]
    if W >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    else:
        slots = positions[-W:] % W
        cache["k"][:, slots] = k[:, -W:].to(cache["k"].dtype)
        cache["v"][:, slots] = v[:, -W:].to(cache["v"].dtype)
    return _tp_out(o.reshape(B, S, -1) @ p["wo"], tp, False), cache


def attention_decode(p: Params, x: Tensor, cfg: ModelConfig, *, kind: str,
                     pos: Tensor, cache: Params, tp=None, seq=None):
    """One-token decode.  x: (B, 1, D); pos: 0-dim int64 absolute position
    (a device tensor: nothing here reads it on the host).

    ``seq`` (a ``dist/group.SeqGroup``): the cache holds this rank's share
    of the slots, block ``seq.rank`` of ``seq.size``; a local layer's ring
    buffer is sharded by slot too, so the owner of slot ``pos % W`` moves
    with ``pos``.  The owner writes the new k and v, every rank attends
    its share (each slot's position from its global index) and
    :func:`seq_combine` joins the shares."""
    B = x.shape[0]
    posv = pos.reshape(1)
    q, k, v = _qkv(p, x, cfg, posv)
    Ws = cache["k"].shape[1]
    n, off = (1, 0) if seq is None else (seq.size, seq.rank * Ws)
    W = Ws * n
    slot = posv % W
    if seq is None:
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    else:
        _seq_write(cache["k"], slot, k, seq)
        _seq_write(cache["v"], slot, v, seq)
    # the absolute position each slot j holds: pos - ((pos - j) mod W)
    j = torch.arange(off, off + Ws, device=x.device)
    kpos = (pos - (pos - j) % W).expand(B, Ws)
    args = (q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), kpos,
            pos.expand(B))
    if seq is None:
        o = decode_attention(*args, window=_window(cfg, kind))
    else:
        o = seq_combine(*decode_attention(*args, window=_window(cfg, kind),
                                          partial=True), seq).to(q.dtype)
    return _tp_out(o.reshape(B, 1, -1) @ p["wo"], tp, False), cache


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int,
                         kind: str, dtype: torch.dtype, device=None) -> Params:
    W = max_len if kind != "local" else min(cfg.window, max_len)
    shape = (batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention)
# ---------------------------------------------------------------------------

def mla_shapes(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, Any]:
    """{name: (shape, dtype)} of one MLA layer's leaves (``init_mla``'s
    layout): the KV down-projection and its norm, the rope key, the K and
    V up-projections, the output, and either the query's low-rank pair
    with its norm (``q_lora_rank`` set) or one query projection."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    out = {"wdkv": ((D, r), dtype), "kv_norm": ((r,), dtype),
           "wkr": ((D, dr), dtype), "wuk": ((r, H * dn), dtype),
           "wuv": ((r, H * dv), dtype), "wo": ((H * dv, D), dtype)}
    if m.q_lora_rank:
        out.update(wdq=((D, m.q_lora_rank), dtype),
                   q_norm=((m.q_lora_rank,), dtype),
                   wuq=((m.q_lora_rank, H * (dn + dr)), dtype))
    else:
        out["wq"] = ((D, H * (dn + dr)), dtype)
    return out


def _mla_q(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """(qn (B, S, H, dn), roped qr (B, S, H, dr))."""
    m = cfg.mla
    B, S, _ = x.shape
    H, dn = cfg.num_heads, m.qk_nope_head_dim
    if m.q_lora_rank:
        q = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    else:
        q = x @ p["wq"]
    q = q.reshape(B, S, H, -1)
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latent(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """What the MLA cache holds: the normed latent ckv (B, S, r) and the
    roped shared key kr (B, S, dr)."""
    ckv = rms_norm(x @ p["wdkv"], p["kv_norm"], cfg.norm_eps)
    kr = rope((x @ p["wkr"])[:, :, None, :], positions, cfg.rope_theta)
    return ckv, kr[:, :, 0]


def _mla_attention(q: Tensor, k: Tensor, v: Tensor, cfg: ModelConfig
                   ) -> Tensor:
    """Causal attention with qk head dim dn + dr and v head dim dv, scaled
    by 1 / sqrt(dn + dr).  Under ``use_pallas`` the kernels take Q, K and V
    zero-padded on the last dim to the smallest dispatched head_dim that
    holds both, with the scale passed explicitly, and the output is cut
    back to dv: zero columns change neither Q K^T nor the kept columns of
    P V, and autograd slices their gradients away."""
    dqk, dv = q.shape[-1], v.shape[-1]
    if cfg.use_pallas:
        D = padded_head_dim(max(dqk, dv))
        pad = lambda t: F.pad(t, (0, D - t.shape[-1]))
        o = _pallas_attention(pad(q), pad(k), pad(v), causal=True, window=0,
                              scale=1.0 / math.sqrt(dqk))
        if o is not None:
            return o[..., :dv]
    return blockwise_attention(q, k, v, causal=True,
                               q_block=cfg.attn_q_block,
                               kv_block=cfg.attn_kv_block)


def _mla_core(p: Params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """Train/prefill MLA with materialized K/V.  Returns (out, ckv, kr)."""
    m = cfg.mla
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.num_heads, m.qk_nope_head_dim, m.qk_rope_head_dim,
                     m.v_head_dim)
    qn, qr = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    kn = (ckv @ p["wuk"]).reshape(B, S, H, dn)
    v = (ckv @ p["wuv"]).reshape(B, S, H, dv)
    q = torch.cat([qn, qr], dim=-1)
    k = torch.cat([kn, kr[:, :, None].expand(B, S, H, dr)], dim=-1)
    o = _mla_attention(q, k, v, cfg)
    return o.reshape(B, S, H * dv) @ p["wo"], ckv, kr


def mla_fwd(p: Params, x: Tensor, cfg: ModelConfig, *,
            positions: Tensor) -> Tensor:
    """Train MLA.  x: (B, S, D)."""
    return _mla_core(p, x, cfg, positions)[0]


def mla_prefill(p: Params, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
                cache: Params):
    """Prefill: MLA over the prompt, the latents into the cache in place."""
    S = x.shape[1]
    out, ckv, kr = _mla_core(p, x, cfg, positions)
    cache["ckv"][:, :S] = ckv
    cache["kr"][:, :S] = kr
    return out, cache


def _mla_absorbed(p: Params, qn: Tensor, qr: Tensor, cview: Tensor,
                  rview: Tensor, pos: Tensor, cfg: ModelConfig,
                  dtype: torch.dtype, seq=None) -> Tensor:
    """Absorbed-matrix MLA decode: W_uk folds into the query, so the
    scores are taken against the latent cache itself, and W_uv is applied
    to the attended latent.  qn (N, 1, H, dn), qr (N, 1, H, dr); cview
    (N, W, r), rview (N, W, dr); pos (N,): cache positions beyond it are
    masked to -inf.  The einsums are f32.  Returns (N, 1, D) in
    ``dtype``.  ``seq``: the views are this rank's share of the positions
    (block ``seq.rank``), and the attended latents of the shares are
    joined by :func:`seq_combine` before W_uv."""
    m = cfg.mla
    N = qn.shape[0]
    H, dn, dr, dv, r = (cfg.num_heads, m.qk_nope_head_dim,
                        m.qk_rope_head_dim, m.v_head_dim, m.kv_lora_rank)
    cf = cview.float()
    q_lat = torch.einsum("bhd,rhd->bhr", qn[:, 0].float(),
                         p["wuk"].reshape(r, H, dn).float())
    s = (torch.einsum("bhr,bsr->bhs", q_lat, cf)
         + torch.einsum("bhd,bsd->bhs", qr[:, 0].float(), rview.float()))
    s = s / math.sqrt(dn + dr)
    Ws = cview.shape[1]
    off = 0 if seq is None else seq.rank * Ws
    kpos = torch.arange(off, off + Ws, device=cview.device)
    s = torch.where(kpos[None, None] <= pos[:, None, None], s, -math.inf)
    if seq is None:
        lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), cf)
    else:
        w, mx, l = _partial_softmax(s)
        lat = seq_combine(torch.einsum("bhs,bsr->bhr", w, cf)[:, None],
                          mx, l, seq)[:, 0]
    o = torch.einsum("bhr,rhd->bhd", lat,
                     p["wuv"].reshape(r, H, dv).float())
    return o.reshape(N, 1, H * dv).to(dtype) @ p["wo"]


def mla_decode(p: Params, x: Tensor, cfg: ModelConfig, *, pos: Tensor,
               cache: Params, seq=None):
    """One-token absorbed-matrix MLA decode: it attends in the latent
    space, so the cache is r + dr a token instead of 2 H Dh.  pos: 0-dim
    int64 device tensor.  ``seq`` as :func:`attention_decode`'s: the
    latent cache holds this rank's share of the positions."""
    B = x.shape[0]
    posv = pos.reshape(1)
    qn, qr = _mla_q(p, x, cfg, posv)
    ckv, kr = _mla_latent(p, x, cfg, posv)
    if seq is None:
        cache["ckv"].index_copy_(1, posv, ckv.to(cache["ckv"].dtype))
        cache["kr"].index_copy_(1, posv, kr.to(cache["kr"].dtype))
    else:
        _seq_write(cache["ckv"], posv, ckv, seq)
        _seq_write(cache["kr"], posv, kr, seq)
    o = _mla_absorbed(p, qn, qr, cache["ckv"], cache["kr"], pos.expand(B),
                      cfg, x.dtype, seq=seq)
    return o, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device=None) -> Params:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                              dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Paged (block-table) attention: the serving engine's cache views
# ---------------------------------------------------------------------------
#
# The serve cache is a flat pool of fixed-size pages shared by all slots
# (repro_torch.serve.kvcache).  Prefill scatters a prompt's K/V through one
# slot's page list; decode scatters the new token and gathers the slot's
# logical view ``pages[page_table]`` for the attention read.  Positions
# beyond ``pos`` (including unallocated trash-page entries) are masked to
# -inf, so garbage contributes exp(-inf) == 0 -- exactly nothing -- and
# slots stay bit-isolated from each other.  Every index is a device tensor
# and every write an in-place scatter: no host sync.

def _paged_scatter(pages: Tensor, rows: Tensor, positions: Tensor,
                   valid: Tensor, values: Tensor) -> Tensor:
    """Write ``values`` at logical ``positions`` of per-entry page ``rows``,
    in place.  pages: (P, ps, ...); rows: the physical page of each entry;
    positions: logical token positions (rows' shape); valid: bool mask --
    invalid entries go to the trash page 0 (never allocated, never read
    unmasked).  values: positions.shape + pages.shape[2:]."""
    phys = torch.where(valid, rows, torch.zeros_like(rows))
    pages.index_put_((phys, positions % pages.shape[1]),
                     values.to(pages.dtype))
    return pages


def attention_prefill_paged(p: Params, x: Tensor, cfg: ModelConfig, *,
                            kind: str, positions: Tensor, cache: Params,
                            page_row: Tensor, valid_len: Tensor, tp=None):
    """Single-slot prefill into a paged cache.  x: (1, S, D), the prompt
    right-padded to S; ``valid_len`` ((1,) device tensor) marks how many
    leading positions are real -- pad positions are computed (causally
    harmless) but their K/V goes to the trash page."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = _attend(q, k, v, cfg, _window(cfg, kind))
    rows = page_row[positions // cache["k"].shape[1]]
    valid = positions < valid_len
    _paged_scatter(cache["k"], rows, positions, valid, k[0])
    _paged_scatter(cache["v"], rows, positions, valid, v[0])
    return _tp_out(o.reshape(B, S, -1) @ p["wo"], tp, False), cache


def _page_rows(page_table: Tensor, pos: Tensor, ps: int) -> Tensor:
    """The physical page holding each slot's position ``pos``."""
    return page_table.gather(1, (pos // ps)[:, None])[:, 0]


def attention_decode_paged(p: Params, x: Tensor, cfg: ModelConfig, *,
                           kind: str, pos: Tensor, cache: Params,
                           page_table: Tensor, active: Tensor, tp=None):
    """Slot-batched one-token decode over a paged cache.

    x: (N, 1, D); pos: (N,) per-slot absolute positions; page_table:
    (N, Pmax) physical page ids (0 = unallocated); active: (N,) bool --
    inactive slots compute (and are discarded) but write only to the trash
    page.  The pool's KV heads are this rank's (``tp``)."""
    N = x.shape[0]
    K, Dh = cache["k"].shape[-2:]
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = _page_rows(page_table, pos, cache["k"].shape[1])
    _paged_scatter(cache["k"], rows, pos, active, k[:, 0])
    _paged_scatter(cache["v"], rows, pos, active, v[:, 0])
    # the slots' logical views: (N, Pmax * ps, K, Dh)
    kview = cache["k"][page_table].reshape(N, -1, K, Dh)
    vview = cache["v"][page_table].reshape(N, -1, K, Dh)
    kpos = torch.arange(kview.shape[1], device=x.device).expand(N, -1)
    o = decode_attention(q, kview.to(q.dtype), vview.to(q.dtype), kpos, pos,
                         window=_window(cfg, kind))
    return _tp_out(o.reshape(N, 1, -1) @ p["wo"], tp, False), cache


def mla_prefill_paged(p: Params, x: Tensor, cfg: ModelConfig, *,
                      positions: Tensor, cache: Params, page_row: Tensor,
                      valid_len: Tensor):
    """Single-slot MLA prefill into paged latent caches (x: (1, S, D))."""
    out, ckv, kr = _mla_core(p, x, cfg, positions)
    rows = page_row[positions // cache["ckv"].shape[1]]
    valid = positions < valid_len
    _paged_scatter(cache["ckv"], rows, positions, valid, ckv[0])
    _paged_scatter(cache["kr"], rows, positions, valid, kr[0])
    return out, cache


def mla_decode_paged(p: Params, x: Tensor, cfg: ModelConfig, *, pos: Tensor,
                     cache: Params, page_table: Tensor, active: Tensor):
    """Slot-batched absorbed-matrix MLA decode over paged latent caches."""
    N = x.shape[0]
    posv = pos[:, None]
    qn, qr = _mla_q(p, x, cfg, posv)
    ckv, kr = _mla_latent(p, x, cfg, posv)
    rows = _page_rows(page_table, pos, cache["ckv"].shape[1])
    _paged_scatter(cache["ckv"], rows, pos, active, ckv[:, 0])
    _paged_scatter(cache["kr"], rows, pos, active, kr[:, 0])
    cview = cache["ckv"][page_table].reshape(N, -1, cache["ckv"].shape[-1])
    rview = cache["kr"][page_table].reshape(N, -1, cache["kr"].shape[-1])
    return _mla_absorbed(p, qn, qr, cview, rview, pos, cfg, x.dtype), cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

# the profiler range of the train/prefill cross-attention
# (analysis/step_profile.RANGES)
CROSS_RANGE = "cross_attention"


def cross_kv(p: Params, enc: Tensor, cfg: ModelConfig):
    """k, v (B, T, K, Dh) of the encoder output enc (B, T, D), unroped."""
    B, T, _ = enc.shape
    Dh = cfg.head_dim
    return ((enc @ p["wk"]).reshape(B, T, -1, Dh),
            (enc @ p["wv"]).reshape(B, T, -1, Dh))


def cross_attention_fwd(p: Params, x: Tensor, enc: Tensor,
                        cfg: ModelConfig) -> Tensor:
    """Train/prefill cross-attention.  x: (B, S, D) decoder states; enc:
    (B, T, D) encoder output; every encoder position visible, no rope."""
    B, S, _ = x.shape
    with record_function(CROSS_RANGE):
        q = (x @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
        k, v = cross_kv(p, enc, cfg)
        o = blockwise_attention(q, k, v, causal=False,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
        return o.reshape(B, S, -1) @ p["wo"]


def cross_attention_decode(p: Params, x: Tensor, cfg: ModelConfig,
                           kv, seq=None) -> Tensor:
    """Decode-time cross-attention of x (B, 1, D) over the cached encoder
    k, v (B, T, K, Dh), every position visible.  ``seq``: k, v hold this
    rank's share of the encoder positions (:func:`attention_decode`'s)."""
    B = x.shape[0]
    k, v = kv
    T = k.shape[1]
    n, off = (1, 0) if seq is None else (seq.size, seq.rank * T)
    q = (x @ p["wq"]).reshape(B, 1, -1, cfg.head_dim)
    kpos = torch.arange(off, off + T, device=x.device).expand(B, T)
    args = (q, k.to(q.dtype), v.to(q.dtype), kpos,
            torch.full((B,), n * T, device=x.device))
    if seq is None:
        o = decode_attention(*args)
    else:
        o = seq_combine(*decode_attention(*args, partial=True),
                        seq).to(q.dtype)
    return o.reshape(B, 1, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_fwd(p: Params, x: Tensor, *, tp=None,
            sequence_parallel: bool = False) -> Tensor:
    """SwiGLU MLP; ``tp``: wg/wu column- and wd row-sharded over the model
    group, with :func:`attention_fwd`'s enter and join."""
    x = _tp_in(x, tp, sequence_parallel)
    y = (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return _tp_out(y, tp, sequence_parallel)


# ---------------------------------------------------------------------------
# Embedding / unembedding / loss
# ---------------------------------------------------------------------------

def embed(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    x = p["tok"][tokens]
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def unembed(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return x @ p["tok"].T
    return x @ p["unembed"]


def _xent_parts(logits: Tensor, valid_vocab: Optional[int]):
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits + torch.where(col < valid_vocab, 0.0, -1e30).to(
            logits.dtype)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    z = e.float().sum(dim=-1)
    return logits, m, e, z


class _SoftmaxXent(torch.autograd.Function):
    """The JAX custom VJP of ``softmax_xent``: d(logits) = (softmax -
    onehot) / N, produced in the logits' dtype; reductions in f32.  Plain
    PyTorch both ways, so ``torch.func.vmap`` batches it by running
    ``forward`` and ``backward`` under itself (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(logits, labels, valid_vocab):
        lm, m, _, z = _xent_parts(logits, valid_vocab)
        lse = torch.log(z) + m[..., 0].float()
        gold = torch.gather(lm, -1, labels[..., None])[..., 0]
        return (lse - gold.float()).mean()

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, ctx.valid_vocab = inputs
        ctx.save_for_backward(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        dt = logits.dtype
        _, _, e, z = _xent_parts(logits, ctx.valid_vocab)
        dlogits = e * (1.0 / z)[..., None].to(dt)
        # minus the one-hot row, without materializing it
        dlogits.scatter_add_(-1, labels[..., None],
                             torch.full_like(labels[..., None], -1, dtype=dt))
        return dlogits * (g / labels.numel()).to(dt), None, None


def softmax_xent(logits: Tensor, labels: Tensor,
                 valid_vocab: Optional[int] = None) -> Tensor:
    """Mean cross-entropy.  logits: (..., V); labels: (...,) int.
    ``valid_vocab`` masks padded vocab columns with -1e30."""
    return _SoftmaxXent.apply(logits, labels.long(), valid_vocab)
