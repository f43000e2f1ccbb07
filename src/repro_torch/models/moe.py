"""Mixture-of-experts FFN of the port: shared + routed experts, top-k
routing (``repro/models/moe.py``).

Two paths, as in the reference:

* ``moe_fwd_dense`` computes every held expert on every token and combines
  them by the routing weights: exact, O(E) compute, the plain version and
  the oracle of the other.  A card may hold only a share of the experts
  (``MoEConfig.experts_held``): the router still scores all
  ``num_experts``, and only the routing slots that pick a held expert are
  combined (``first_expert=`` says which share).
* ``moe_fwd_ep`` (``impl="ep"``) is expert parallelism over a model group
  (``dist/group.ModelGroup``) whose rank t holds experts ``[t E / T, (t +
  1) E / T)``: each rank routes its slice of the tokens, sorts the routed
  slots by expert, keeps the first ``C`` of each expert (the capacity) and
  drops the rest, exchanges the kept slots with an all-to-all, runs its
  own experts, exchanges the outputs back, combines them and all-gathers
  the tokens.  Too few tokens to slice (fewer than 4 a rank) take the
  small path instead: every rank routes every token, runs its own experts
  densely, and the partial outputs are summed over the group.  Without a
  group, the group is of one (``ep = 1``): the reference's host mesh,
  where the capacity still drops slots.

Both return ``(out, aux)``, aux the Switch load-balancing loss
E * sum_e f_e * P_e over all E experts; under expert parallelism each rank
takes it over its own tokens and the group's mean is the layer's, as the
reference's ``pmean``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.dist.group import ModelGroup
from repro_torch.models import layers as L

Tensor = torch.Tensor
Params = Dict[str, Any]

# profiler ranges (analysis/step_profile.py attributes their kernels);
# the exchange range holds expert parallelism's collectives
ROUTE_RANGE, EXPERTS_RANGE, COMBINE_RANGE, EXCHANGE_RANGE = \
    "moe_route", "moe_experts", "moe_combine", "moe_exchange"

# who watches the capacity: each routed layer of ``moe_fwd_ep`` calls every
# sink with (its dropped slots, a 0-d device tensor; its routed slots)
DROP_SINKS: List[Callable[[Tensor, int], None]] = []


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


def _held_experts(p: Params, xf: Tensor, m: MoEConfig, first_expert: int,
                  shared: bool = False) -> Tuple[Tensor, Tensor]:
    """The dense path: every held expert on every token of ``xf`` (N, D),
    combined by the routing weights of the slots that pick a held expert
    (experts ``[first_expert, first_expert + E_held)`` of the router's E),
    plus the shared expert when ``shared``.  Returns (out (N, D), aux)."""
    N, D = xf.shape
    held = p["wg"].shape[0]
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
        w = torch.where(mine, topv, 0.0).to(xf.dtype)
        combine = torch.zeros((N, held), dtype=xf.dtype, device=xf.device
                              ).scatter_add(1, slot.clamp(0, held - 1), w)
        out = torch.einsum("ne,end->nd", combine, y)
        if shared:
            out = out + L.ffn_fwd(p["shared"], xf)
    return out, aux


def moe_fwd_dense(p: Params, x: Tensor, cfg: ModelConfig, *,
                  first_expert: int = 0) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux).  The weights hold experts
    ``[first_expert, first_expert + E_held)`` of the router's E."""
    m = cfg.moe
    B, S, D = x.shape
    out, aux = _held_experts(p, x.reshape(-1, D), m, first_expert,
                             shared=bool(m.num_shared))
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Expert-parallel path (the model group acting as the expert axis)
# ---------------------------------------------------------------------------

def capacity(slots: int, num_experts: int, factor: float) -> int:
    """The slots each expert keeps of ``slots`` routed ones: the
    reference's ``max(1, ceil(N k / E * capacity_factor))``."""
    return max(1, int(math.ceil(slots / num_experts * factor)))


def _moe_ep_local(xl: Tensor, p: Params, m: MoEConfig, group
                  ) -> Tuple[Tensor, Tensor]:
    """One rank's routed slice ``xl`` (n, D): route, keep the first ``C``
    slots of each expert in a stable sort by expert (the reference's
    ``argsort`` order), exchange, run the held experts, exchange back and
    combine.  Returns (out (n, D), this rank's aux).

    The dispatch writes each kept slot once (a dropped slot goes to a bin
    that is cut off), and the combine gathers each token's k slots into
    (n, k, D) and sums over k, so no sum on the card depends on the order
    of atomic adds; the dispatch's adjoint is the same gather."""
    E = p["router"].shape[1]
    T = group.size
    E_loc = p["wg"].shape[0]
    n, D = xl.shape
    k = m.top_k
    nk = n * k
    with record_function(ROUTE_RANGE):
        topv, topi, aux = _route(xl, p["router"], m)
        eid = topi.reshape(nk)
        order = torch.argsort(eid, stable=True)
        eid_s = eid[order]
        C = capacity(nk, E, m.capacity_factor)
        # position of each routed slot within its expert: its place in the
        # sorted order after the expert's first slot
        counts = torch.zeros(E, dtype=eid.dtype, device=eid.device
                             ).scatter_add_(0, eid, torch.ones_like(eid))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(nk, device=eid.device) - starts[eid_s]
        keep = pos < C
        slot_s = torch.where(keep, eid_s * C + pos, E * C)  # E*C: drop bin
        # back in (token, choice) order
        slot = torch.empty_like(slot_s).scatter_(0, order, slot_s)
        for sink in DROP_SINKS:
            sink((~keep).sum(), nk)
        xk = xl.unsqueeze(1).expand(n, k, D).reshape(nk, D)
        send = xl.new_zeros((E * C + 1, D)).index_put((slot,), xk)
        send = send[:-1].reshape(T, E_loc, C, D)
    with record_function(EXCHANGE_RANGE):
        recv = L.ep_all_to_all(send, group)
    with record_function(EXPERTS_RANGE):
        # recv[src, e_loc] -> per local expert: (E_loc, T C, D)
        xin = recv.transpose(0, 1).reshape(E_loc, T * C, D)
        g = torch.bmm(xin, p["wg"])
        u = torch.bmm(xin, p["wu"])
        y = torch.bmm(F.silu(g) * u, p["wd"])
        yb = y.reshape(E_loc, T, C, D).transpose(0, 1).contiguous()
    with record_function(EXCHANGE_RANGE):
        back = L.ep_all_to_all(yb, group)
    with record_function(COMBINE_RANGE):
        back = torch.cat([back.reshape(E * C, D), back.new_zeros((1, D))])
        contrib = back[slot] * topv.reshape(nk, 1).to(back.dtype)
        out = contrib.reshape(n, k, D).sum(1)
        if m.num_shared:
            out = out + L.ffn_fwd(p["shared"], xl)
    return out, aux


def _moe_ep_small(xf: Tensor, p: Params, m: MoEConfig, group
                  ) -> Tuple[Tensor, Tensor]:
    """Too few tokens to slice: every rank routes all of ``xf`` (N, D),
    runs its own experts densely and the partial outputs are summed over
    the group (``tp_psum``).  The input enters the group (``tp_enter``),
    so its cotangent, partial on each rank, is summed there; the shared
    expert, which every rank computes alike, passes each rank its share of
    the cotangent (``model_share``), so its weight gradients are partial
    like the router's and sum over the group to the whole."""
    E_loc = p["wg"].shape[0]
    xe = L.tp_enter(xf, group)
    part, aux = _held_experts(p, xe, m, group.rank * E_loc)
    with record_function(EXCHANGE_RANGE):
        out = L.tp_psum(part, group)
    if m.num_shared:
        with record_function(COMBINE_RANGE):
            out = out + L.model_share(L.ffn_fwd(p["shared"], xe), group)
    return out, aux


def moe_fwd_ep(p: Params, x: Tensor, cfg: ModelConfig, *,
               group: Optional[ModelGroup] = None) -> Tuple[Tensor, Tensor]:
    """Expert-parallel MoE over ``group`` (None: a group of one).  x:
    (B, S, D), the same rows on every rank of the group; the expert
    weights are this rank's share, ``E / T`` experts, and the router and
    the shared expert are whole.

    Each rank routes and dispatches its slice of the N tokens (``N / T``,
    ``sp_slice``; N must split over T) and the outputs are all-gathered
    (``sp_unslice``), so everything after the layer runs alike on every
    rank.  Fewer than ``4 T`` tokens (decode, tiny batches) take the small
    path.  The gradients of the router and of the shared expert are each
    rank's part (its tokens'), to be summed over the group once per step;
    those of the held experts are whole; the input's is whole.  aux is
    the group's mean of each rank's Switch loss over its own tokens."""
    m = cfg.moe
    group = group or ModelGroup()
    T = group.size
    E, held = p["router"].shape[1], p["wg"].shape[0]
    if held * T != E:
        raise ValueError(f"expert parallelism over {T} ranks holding {held} "
                         f"experts each, but the router scores {E}")
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    if N < 4 * T:                   # decode / tiny batches
        out, aux = _moe_ep_small(xf, p, m, group)
    else:
        if N % T:
            raise ValueError(f"moe_fwd_ep: {N} tokens do not split over the "
                             f"{T} ranks of the expert axis")
        xs = L.sp_slice(xf, group, 0)
        out, aux = _moe_ep_local(xs, p, m, group)
        with record_function(EXCHANGE_RANGE):
            out = L.sp_unslice(out, group, 0)
    with record_function(EXCHANGE_RANGE):
        aux = L.model_mean(aux.reshape(1), group)[0]
    return out.reshape(B, S, D), aux


def moe_fwd_held(p: Params, x: Tensor, cfg: ModelConfig, *,
                 group: ModelGroup) -> Tensor:
    """The dense layer (``impl="dense"``) with its experts split over
    ``group``, forward only (the serving grid's; ``lm``'s cached modes): at
    any row count every rank runs its held experts on every token and the
    partial outputs are summed, :func:`moe_fwd_ep`'s small path, so the
    layer is the one-device dense layer's, with no slot dropped.  x:
    (B, S, D), the same rows on every rank; the router and the shared
    expert whole.  The aux is not reduced (the cached modes drop it)."""
    B, S, D = x.shape
    out, _ = _moe_ep_small(x.reshape(-1, D), p, cfg.moe, group)
    return out.reshape(B, S, D)


def moe_fwd(p: Params, x: Tensor, cfg: ModelConfig, *,
            group: Optional[ModelGroup] = None) -> Tuple[Tensor, Tensor]:
    """The config's path: ``impl="ep"`` runs :func:`moe_fwd_ep` over
    ``group``; ``"dense"`` runs :func:`moe_fwd_dense`, which holds the
    whole layer, so it takes no group of several ranks."""
    if cfg.moe.impl == "ep":
        return moe_fwd_ep(p, x, cfg, group=group)
    if group is not None and group.size > 1:
        raise ValueError(
            f"MoEConfig(impl='dense') over a model group of {group.size} "
            f"ranks: the group holds a share of the experts a rank, which "
            f"impl='ep' exchanges tokens with")
    return moe_fwd_dense(p, x, cfg)
