"""Mixture-of-experts FFN of the port: shared + routed experts, top-k
routing (the dense path of ``repro/models/moe.py``).

``moe_fwd_dense`` computes every held expert on every token and combines
them by the routing weights: exact, O(E) compute.  A card may hold only a
share of the experts (``MoEConfig.experts_held``): the router still scores
all ``num_experts``, and only the routing slots that pick a held expert
are combined -- one rank's part of an expert-parallel layer, as
``_moe_ep_small`` computes it in the reference before its ``psum``.  The
exchange across ranks (``impl="ep"``) is not ported.

Both return ``(out, aux)``, aux the Switch load-balancing loss
E * sum_e f_e * P_e over all E experts.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor
Params = Dict[str, Any]

# profiler ranges (analysis/step_profile.py attributes their kernels)
ROUTE_RANGE, EXPERTS_RANGE, COMBINE_RANGE = \
    "moe_route", "moe_experts", "moe_combine"


def moe_shapes(cfg: ModelConfig, dtype: torch.dtype) -> Dict[str, Any]:
    """{name: (shape, dtype)} of one MoE layer's leaves, ``init_moe``'s
    layout with the held experts: the router (D, E) in f32 at any dtype,
    ``wg``/``wu`` (E_held, D, F), ``wd`` (E_held, F, D) and a shared
    SwiGLU FFN of width ``num_shared * F``."""
    m = cfg.moe
    D, F_ = cfg.d_model, m.d_ff_expert
    held = m.experts_held or m.num_experts
    out: Dict[str, Any] = {
        "router": ((D, m.num_experts), torch.float32),
        "wg": ((held, D, F_), dtype), "wu": ((held, D, F_), dtype),
        "wd": ((held, F_, D), dtype)}
    if m.num_shared:
        fs = m.num_shared * F_
        out["shared"] = {"wg": ((D, fs), dtype), "wu": ((D, fs), dtype),
                         "wd": ((fs, D), dtype)}
    return out


def _route(xf: Tensor, router: Tensor, m: MoEConfig
           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Top-k routing.  xf: (N, D).  Returns (weights (N, k), ids (N, k),
    aux).  The logits are an f32 product: a slot near a tie must not flip
    its expert on a lower-precision product."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    topv, topi = torch.topk(probs, m.top_k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # Switch load-balance loss: E * sum_e f_e * P_e
    E = router.shape[1]
    f = F.one_hot(topi[:, 0], E).float().mean(0)
    P = probs.mean(0)
    return topv, topi, E * torch.sum(f * P)


def moe_fwd_dense(p: Params, x: Tensor, cfg: ModelConfig, *,
                  first_expert: int = 0) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux).  The weights hold experts
    ``[first_expert, first_expert + E_held)`` of the router's E."""
    m = cfg.moe
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    N, held = xf.shape[0], p["wg"].shape[0]
    with record_function(ROUTE_RANGE):
        topv, topi, aux = _route(xf, p["router"], m)
    with record_function(EXPERTS_RANGE):
        # every held expert on every token, (E_held, N, .)
        xe = xf.expand(held, N, D)
        g = torch.bmm(xe, p["wg"])
        u = torch.bmm(xe, p["wu"])
        y = torch.bmm(F.silu(g) * u, p["wd"])
    with record_function(COMBINE_RANGE):
        # the routing weights in x's dtype, only the slots of held experts
        slot = topi - first_expert
        mine = (slot >= 0) & (slot < held)
        w = torch.where(mine, topv, 0.0).to(x.dtype)
        combine = torch.zeros((N, held), dtype=x.dtype, device=x.device
                              ).scatter_add(1, slot.clamp(0, held - 1), w)
        out = torch.einsum("ne,end->nd", combine, y)
        if m.num_shared:
            out = out + L.ffn_fwd(p["shared"], xf)
    return out.reshape(B, S, D), aux


def moe_fwd(p: Params, x: Tensor, cfg: ModelConfig
            ) -> Tuple[Tensor, Tensor]:
    if cfg.moe.impl == "ep":
        raise NotImplementedError(
            "MoEConfig(impl='ep'): the all_to_all exchange across ranks "
            "comes with the multi-GPU slice (ROADMAP.md Queue 1 B item 11)")
    return moe_fwd_dense(p, x, cfg)
