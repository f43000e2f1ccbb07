"""Plain oracle for the attention kernels (counterpart of
``repro/kernels/ref.py::attention_ref``).

Deliberately naive -- it materializes the (Sq, Sk) score matrix -- so it
is the semantic ground truth the kernel tests assert against at small
shapes.
"""
from __future__ import annotations

import math

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
