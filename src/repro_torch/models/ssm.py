"""Mamba-2 (SSD) and RG-LRU (Griffin) blocks of the port: train, prefill
and one-token decode (``repro/models/ssm.py``).

Each scan runs its hand-written kernels (``repro_torch.kernels.ops.ssd``,
``ops.rglru``) when ``cfg.use_pallas`` is set (they raise on the card for
a shape or dtype they do not take); otherwise a plain chunked path
(:func:`_ssd_scan`, :func:`_lru_scan`) that keeps the JAX path's rounding
points.  Prefill is the train path's core, which also returns the final
state and the conv window's tail; decode advances that state one token
(:func:`conv_step` and the recurrence in f32), in place in the layer's
cache.  The large projections are ``torch.matmul``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm

Tensor = torch.Tensor
Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------

def _conv_sum(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """sum_k xp[:, k:k+S] * w[k] + b in f32, k ascending (the JAX order),
    xp = x left-padded by K - 1 zeros."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    wf = w.float()
    out = torch.zeros_like(x, dtype=torch.float32)
    for k in range(K):
        out = out + xp[:, k:k + S].float() * wf[k]
    return out + b.float()


class _CausalConv(torch.autograd.Function):
    """Autograd keeps only x (storage dtype) and the weights; the f32 sums
    are rebuilt in the backward.  Out-of-place plain PyTorch both ways, so
    ``torch.func.vmap`` batches it by running ``forward`` and ``backward``
    under itself (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, b):
        return _conv_sum(x, w, b).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        K, S = w.shape[0], x.shape[1]
        gf = g.float()
        xp = F.pad(x, (0, 0, K - 1, 0))
        gp = F.pad(gf, (0, 0, 0, K - 1))
        wf = w.float()
        dx = torch.zeros_like(x, dtype=torch.float32)
        for k in range(K):
            # out[s] += x[s + k - K + 1] * w[k]
            dx = dx + gp[:, K - 1 - k:K - 1 - k + S] * wf[k]
        dw = torch.stack([
            torch.einsum("bsc,bsc->c", gf, xp[:, k:k + S].float())
            for k in range(K)])
        return (dx.to(x.dtype), dw.to(w.dtype),
                gf.sum(dim=(0, 1)).to(ctx.b_dtype))


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x: (B, S, C); w: (K, C) depthwise; left-padded causal conv, f32
    sums, output in x's dtype."""
    return _CausalConv.apply(x, w, b)


def conv_step(xt: Tensor, conv_state: Tensor, w: Tensor, b: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """One-token causal conv.  xt: (B, C); conv_state: (B, K-1, C), the
    last K - 1 pre-activation inputs.  Returns (out in xt's dtype, the
    next conv_state)."""
    window = torch.cat([conv_state, xt[:, None]], dim=1)       # (B, K, C)
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return out.to(xt.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def _mamba2_split(p: Params, x: Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    G, N = s.n_groups, s.d_state
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * G * N, H], dim=-1)
    return z, xbc, dt, d_in, H, G, N


def _ssd_scan(xh: Tensor, dA: Tensor, Bm: Tensor, Cm: Tensor, state0: Tensor,
              chunk: int) -> Tuple[Tensor, Tensor]:
    """Plain chunked SSD.  xh: (B,S,H,P) inputs pre-multiplied by dt; dA:
    (B,S,H) f32; Bm, Cm: (B,S,H,N).  The (B,Q,Q,H) product is rounded to
    xh's dtype before it meets x, sums are f32, decays and state f32, and
    the chunk's y is rounded to xh's dtype: the JAX path's rounding points.
    Returns (y in xh's dtype, state f32)."""
    B_, S, H, P = xh.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:     # zero-input, zero-decay (exp(0)=1) padding leaves state fixed
        zpad = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xh, dA, Bm, Cm = zpad(xh), zpad(dA), zpad(Bm), zpad(Cm)
    dt = xh.dtype
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    state, ys = state0, []
    for q0 in range(0, S + pad, Q):
        xq, dq, bq, cq = (t[:, q0:q0 + Q] for t in (xh, dA, Bm, Cm))
        csum = torch.cumsum(dq.float(), dim=1)                  # (B,Q,H)
        L = torch.exp(csum[:, :, None] - csum[:, None, :])      # (B,Q,Q,H)
        L = torch.where(tri[None, :, :, None], L, 0.0)
        scores = torch.einsum("blhn,bshn->blsh", cq.float(), bq.float())
        y = torch.einsum("blsh,bshp->blhp", (scores * L).to(dt).float(),
                         xq.float())
        y = y + torch.einsum("blhn,bhpn->blhp", cq.float(), state) \
            * torch.exp(csum)[..., None]
        decay = torch.exp(csum[:, -1:, :] - csum)               # (B,Q,H)
        state = state * torch.exp(csum[:, -1])[..., None, None] \
            + torch.einsum("bshn,bshp,bsh->bhpn", bq.float(), xq.float(),
                           decay)
        ys.append(y.to(dt))
    return torch.cat(ys, dim=1)[:, :S], state


def _use_pallas_ssd(cfg: ModelConfig, S: int, P: int, N: int) -> bool:
    """Route the train scan through the hand-written SSD kernels?  Opt-in
    via ``cfg.use_pallas``, as JAX's gate is off the TPU.  On the card a
    (P, N), dtype or chunk the kernels do not take raises in the kernel
    wrappers; on the CPU their plain versions take any shape."""
    return cfg.use_pallas


def mamba2_core(p: Params, x: Tensor, cfg: ModelConfig
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (B,S,D) -> (out, final_state, conv_tail)."""
    s = cfg.ssm
    B_, S, _ = x.shape
    z, xbc, dt, d_in, H, G, N = _mamba2_split(p, x, cfg)
    xbc_conv = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xbc_conv, [d_in, G * N, G * N], dim=-1)
    P = s.head_dim
    xh = xs.reshape(B_, S, H, P)
    # broadcast the groups over heads: at one group a view with head
    # stride 0; at several a copy, as jnp.repeat makes
    rep = H // G
    Bm = Bm.reshape(B_, S, G, 1, N).expand(B_, S, G, rep, N).reshape(
        B_, S, H, N)
    Cm = Cm.reshape(B_, S, G, 1, N).expand(B_, S, G, rep, N).reshape(
        B_, S, H, N)
    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B,S,H)
    A = -torch.exp(p["A_log"])                                  # (H,)
    dA = dt * A
    xdt = xh * dt[..., None].to(xh.dtype)
    if _use_pallas_ssd(cfg, S, P, N):
        y, state = ops.ssd(xdt, dA, Bm, Cm, chunk=s.chunk)
        y = y.to(xh.dtype)
    else:
        state0 = torch.zeros((B_, H, P, N), dtype=torch.float32,
                             device=x.device)
        y, state = _ssd_scan(xdt, dA, Bm, Cm, state0, s.chunk)
    y = y + p["D"].to(xh.dtype)[None, None, :, None] * xh
    y = y.reshape(B_, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    conv_tail = xbc[:, -(s.d_conv - 1):]    # pre-activation conv window tail
    return out, state, conv_tail


def mamba2_fwd(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    out, _, _ = mamba2_core(p, x, cfg)
    return out


def mamba2_prefill(p: Params, x: Tensor, cfg: ModelConfig, cache: Params):
    """The train path over the prompt; its final state and conv tail into
    the cache, in place."""
    out, state, conv_tail = mamba2_core(p, x, cfg)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_tail)
    return out, cache


def mamba2_decode(p: Params, x: Tensor, cfg: ModelConfig, cache: Params):
    """One-token step.  x: (B, 1, D); the state update in f32."""
    s = cfg.ssm
    B_ = x.shape[0]
    z, xbc, dt, d_in, H, G, N = _mamba2_split(p, x, cfg)
    z, xbc, dt = z[:, 0], xbc[:, 0], dt[:, 0]
    conv_out, new_conv = conv_step(xbc, cache["conv"].to(xbc.dtype),
                                   p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(F.silu(conv_out), [d_in, G * N, G * N], dim=-1)
    P, rep = s.head_dim, H // G
    xh = xs.reshape(B_, H, P).float()
    # each group repeated over its heads, as jnp.repeat
    Bm = Bm.reshape(B_, G, 1, N).expand(B_, G, rep, N).reshape(B_, H, N)
    Cm = Cm.reshape(B_, G, 1, N).expand(B_, G, rep, N).reshape(B_, H, N)
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    state = cache["state"].float() * dA[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", xh, Bm.float(), dt)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), state) \
        + p["D"][None, :, None] * xh
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z[:, None]), p["norm"], cfg.norm_eps)
    cache["state"].copy_(state)
    cache["conv"].copy_(new_conv)
    return y @ p["out_proj"], cache


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device=None) -> Params:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return {"state": torch.zeros((batch, H, s.head_dim, s.d_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

C_SCALE = 8.0   # Griffin's fixed c constant
# profiler ranges around the RG-LRU gates and scan, which
# analysis/step_profile.py reads
GATES_RANGE, SCAN_RANGE = "rglru_gates", "rglru_scan"


def _rglru_gates(p: Params, xw: Tensor) -> Tuple[Tensor, Tensor]:
    """a_t and the gated input, f32.  xw: (..., W) post-conv branch
    activations in f32; the gate products run in f32 (no TF32)."""
    r = torch.sigmoid(xw @ p["wa"].to(xw.dtype) + p["ba"])
    i = torch.sigmoid(xw @ p["wx"].to(xw.dtype) + p["bx"])
    log_a = -C_SCALE * F.softplus(-p["lam"]) * r   # log sigmoid(lam)*c*r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * xw)
    return a, gated


def _lru_scan(a: Tensor, b: Tensor, h0: Tensor, chunk: int
              ) -> Tuple[Tensor, Tensor]:
    """Plain h_t = a_t h_{t-1} + b_t, chunk by chunk.  a, b: (B,S,W) f32;
    h0: (B,W).  Within a chunk a Hillis-Steele doubling scan with the JAX
    combine (a1 a2, a2 b1 + b2) gives every prefix at once; the carry
    enters as h = A h_prev + Bv.  Returns (h (B,S,W), final state)."""
    S = a.shape[1]
    Q = min(chunk, S)
    h, hs = h0, []
    # a ragged tail is a short last chunk, which is what JAX's (a=1, b=0)
    # padding of it computes
    for q0 in range(0, S, Q):
        A, Bv = a[:, q0:q0 + Q], b[:, q0:q0 + Q]
        off = 1
        while off < A.shape[1]:
            A, Bv = (torch.cat([A[:, :off], A[:, off:] * A[:, :-off]], 1),
                     torch.cat([Bv[:, :off], A[:, off:] * Bv[:, :-off]
                                + Bv[:, off:]], 1))
            off *= 2
        hq = A * h[:, None] + Bv
        h = hq[:, -1]
        hs.append(hq)
    return torch.cat(hs, dim=1), h


def _use_pallas_rglru(cfg: ModelConfig) -> bool:
    """Route the train scan through the hand-written RG-LRU kernels?
    ``cfg.use_pallas`` alone, as JAX's gate off the TPU; on the card an
    input the kernels do not take raises in their wrappers."""
    return cfg.use_pallas


def rglru_core(p: Params, x: Tensor, cfg: ModelConfig
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """x: (B,S,D) -> (out, final state (B,W) f32, conv_tail)."""
    lru = cfg.lru
    B_, S, D = x.shape
    W = lru.lru_width or D
    z = F.gelu(x @ p["in_z"], approximate="tanh")   # jax.nn.gelu's default
    xb = x @ p["in_x"]
    xc = F.silu(causal_conv(xb, p["conv_w"], p["conv_b"]))
    with record_function(GATES_RANGE):
        a, gated = _rglru_gates(p, xc.float())
    with record_function(SCAN_RANGE):
        if _use_pallas_rglru(cfg):
            h = ops.rglru(a, gated)
            hT = h[:, -1]
        else:
            h0 = torch.zeros((B_, W), dtype=torch.float32, device=x.device)
            h, hT = _lru_scan(a, gated, h0, lru.block_width)
    y = (h.to(x.dtype) * z) @ p["out_proj"]
    conv_tail = xb[:, -(lru.d_conv - 1):]
    return y, hT, conv_tail


def rglru_fwd(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    out, _, _ = rglru_core(p, x, cfg)
    return out


def rglru_prefill(p: Params, x: Tensor, cfg: ModelConfig, cache: Params):
    """The train path over the prompt; its final state and conv tail into
    the cache, in place."""
    y, hT, conv_tail = rglru_core(p, x, cfg)
    cache["state"].copy_(hT)
    cache["conv"].copy_(conv_tail)
    return y, cache


def rglru_decode(p: Params, x: Tensor, cfg: ModelConfig, cache: Params):
    """One-token step.  x: (B, 1, D); h = a h + gated input in f32."""
    z = F.gelu(x[:, 0] @ p["in_z"], approximate="tanh")
    xb = x[:, 0] @ p["in_x"]
    conv_out, new_conv = conv_step(xb, cache["conv"].to(xb.dtype),
                                   p["conv_w"], p["conv_b"])
    a, gated = _rglru_gates(p, F.silu(conv_out).float())
    h = a * cache["state"] + gated
    cache["state"].copy_(h)
    cache["conv"].copy_(new_conv)
    return ((h.to(x.dtype) * z) @ p["out_proj"])[:, None], cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Params:
    lru = cfg.lru
    W = lru.lru_width or cfg.d_model
    return {"state": torch.zeros((batch, W), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, lru.d_conv - 1, W), dtype=dtype,
                                device=device)}
