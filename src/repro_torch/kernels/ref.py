"""Plain oracles for the kernels (counterpart of ``repro/kernels/ref.py``:
``attention_ref``, ``ssd_ref_with_state``, ``ssd_ref``, ``rglru_ref``).

Deliberately naive -- attention materializes the (Sq, Sk) score matrix,
the SSD and RG-LRU scans step one position at a time -- so they are the semantic
ground truth the tests assert against at small shapes.  Nothing on the
card's path calls them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H = K*G.  f32 softmax."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qv = q.reshape(B, Sq, K, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qv, k.float()) / math.sqrt(D)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", w, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def ssd_ref_with_state(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
                       C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence in f32, differentiable by autograd.

    xdt: (B, S, H, P) inputs pre-multiplied by dt; dA: (B, S, H) = dt * A
    (negative); B_, C: (B, S, H, N).
    h_t = exp(dA_t) * h_{t-1} + B_t^T xdt_t ;  y_t = C_t h_t
    Returns (y: (B, S, H, P) f32, final state: (B, H, P, N) f32)."""
    Bb, S, H, P = xdt.shape
    N = B_.shape[-1]
    x, a, b, c = (t.float() for t in (xdt, dA, B_, C))
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t])[..., None, None] + \
            torch.einsum("bhn,bhp->bhpn", b[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", c[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_ref(xdt: torch.Tensor, dA: torch.Tensor, B_: torch.Tensor,
            C: torch.Tensor) -> torch.Tensor:
    """y of :func:`ssd_ref_with_state`."""
    return ssd_ref_with_state(xdt, dA, B_, C)[0]


def rglru_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sequential linear recurrence, differentiable by autograd.
    a, b: (B, S, W); h_t = a_t * h_{t-1} + b_t in f32; returns h."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
