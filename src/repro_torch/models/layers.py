"""Dense model layers of the port: norm, RoPE, embedding, SwiGLU FFN, GQA
attention and the loss (the dense subset of ``repro/models/layers.py``).

Plain functions over parameter dictionaries of tensors, in the JAX
package's layouts, so the two packages can be fed the same weights.
Attention runs the hand-written kernels (``repro_torch.kernels.ops``)
when ``cfg.use_pallas`` is set: always on the card, and on the CPU when
the shapes tile as the JAX gate demands; otherwise the plain blockwise
path.  The large projections are ``torch.matmul``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import pair_mask

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
# GQA attention layer
# ---------------------------------------------------------------------------

def _pallas_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: int) -> Optional[Tensor]:
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
                               q_block=qb, kv_block=kb)


def attention_fwd(p: Params, x: Tensor, cfg: ModelConfig, *, kind: str,
                  positions: Tensor) -> Tensor:
    """Train self-attention.  x: (B, S, D)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    H, K = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, K, Dh)
    v = (x @ p["wv"]).reshape(B, S, K, Dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" else 0
    o = None
    if cfg.use_pallas:
        o = _pallas_attention(q, k, v, causal=True, window=window)
    if o is None:
        o = blockwise_attention(q, k, v, causal=True, window=window,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
    return o.reshape(B, S, H * Dh) @ p["wo"]


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_fwd(p: Params, x: Tensor) -> Tensor:
    """SwiGLU MLP."""
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


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
    onehot) / N, produced in the logits' dtype; reductions in f32."""

    @staticmethod
    def forward(ctx, logits, labels, valid_vocab):
        lm, m, _, z = _xent_parts(logits, valid_vocab)
        lse = torch.log(z) + m[..., 0].float()
        gold = torch.gather(lm, -1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels)
        ctx.valid_vocab = valid_vocab
        return (lse - gold.float()).mean()

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
