"""Mamba-2 SSD chunked scan, backward: the two Hopper kernels' wrappers and
their plain versions (counterpart of ``repro/kernels/ssd_bwd.py``).

  * :func:`fwd_res_kernel_layout` -- the forward that also records the
    (P, N) state entering each chunk (``csrc/ssd_fwd.cu`` entry
    ``ssd_fwd_res``, replaces ``_fwd_res_kernel``; the kernels of
    ``kernels/ssd.py``, whose bf16 state pass writes these states);
  * :func:`bwd_kernel_layout` -- the backward (``csrc/ssd_bwd.cu``,
    replaces ``_bwd_kernel``).  In f32 one block per (batch, head) walks
    the chunks in reverse carrying the state adjoint dS; in bf16 the walk
    is split into chunk-parallel phases on the tensor cores, which
    :func:`bwd_chunk_parallel_plain` spells out.

Per chunk, with e = exp(csum), alpha = e[-1], d = exp(csum[-1] - csum),
G = (c b^T) * L and the state S_in entering the chunk, given (dy, dS_out):

    dx = G^T dy + d[:,None] * (b dS_out^T)
    dG = dy x^T;  M = dG * L
    dc = M b + e[:,None] * (dy S_in)
    db = M^T c + d[:,None] * (x dS_out)
    dS_in = alpha dS_out + (dy * e[:,None])^T c
    dcsum = rowsum(dG*G) - colsum(dG*G) + e * rowsum(dy * (c S_in^T))
            - dd * d,  dd = rowsum(b * (x dS_out))
    dcsum[-1] += alpha * sum(dS_out * S_in) + sum(dd * d)
    ddA = reverse cumsum of dcsum within the chunk

Layouts, the short last chunk and the float64 cumsums are as in
``kernels/ssd.py``.  Dispatch: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises, and in a dry run a meta
tensor reports its launch's work (``ssd.ssd_fwd_res_work``,
:func:`ssd_bwd_work`); each wrapper counts its launches in
``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd import (check_aligned, check_layout,
                                     chunk_csum, chunked, decay_matrix,
                                     kernel_dtype_code, launch_fwd, n_chunks,
                                     ssd_fwd_plain, strides3, unchunk,
                                     work_shape, work_terms)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Forward with residuals
# ---------------------------------------------------------------------------

def fwd_res_plain(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, *,
                  chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of the forward-with-residuals kernel: (y, state,
    chunk_states (B,H,nc,P,N)), all f32."""
    return ssd_fwd_plain(x, dA, b, c, chunk=chunk, with_states=True)


def fwd_res_kernel_layout(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, *,
                          chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Forward + residuals; operands as ``ssd.ssd_fwd_kernel_layout``.
    Returns (y (B,S,H,P) f32, state (B,H,P,N) f32, chunk_states
    (B,H,nc,P,N) f32)."""
    if x.device.type == "cpu":
        return fwd_res_plain(x, dA, b, c, chunk=chunk)
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    chunk_states = torch.empty((Bb, H, n_chunks(S, chunk), P, N),
                               dtype=torch.float32, device=x.device)
    y, state = launch_fwd(x, dA, b, c, chunk, chunk_states)
    if x.device.type == "cuda":
        fwd_res_kernel_layout.launches += 1
    return y, state, chunk_states


fwd_res_kernel_layout.launches = 0


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def ssd_bwd_work(*, B, S, H, P, N, chunk, itemsize, groups
                 ) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_bwd`` launch: reads x, dA, b, c, the
    chunk states and the f32 dy and dstate; writes f32 dx, ddA, db and
    dc."""
    pairs, qpn, ins, nc = work_terms(B, S, H, P, N, chunk, itemsize, groups)
    f32 = 4 * (B * H * nc * P * N + B * S * H * P + B * H * P * N
               + B * S * H * P + B * S * H + 2 * B * S * H * N)
    return 2.0 * pairs * (3 * N + 2 * P) + 4 * qpn, ins + f32


def bwd_plain(x: Tensor, dA: Tensor, b: Tensor, c: Tensor,
              chunk_states: Tensor, dy: Tensor, dstate: Tensor, *,
              chunk: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of the backward kernel: the per-chunk formulas of the
    module docstring, chunks walked in reverse.  Returns (dx (B,S,H,P),
    ddA (B,S,H), db, dc (B,S,H,N)), all f32."""
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    xc, bc, cc, dyc = (chunked(t, chunk) for t in (x, b, c, dy))
    csum = chunk_csum(chunked(dA, chunk))                   # (B,nc,Q,H)
    L = decay_matrix(csum)                                  # (B,nc,Q,Q,H)
    e = torch.exp(csum)
    d = torch.exp(csum[:, :, -1:] - csum)
    G = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * L
    dG = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    M = dG * L
    T = dG * G
    s_in = chunk_states.float().transpose(1, 2)             # (B,nc,H,P,N)
    dy_s = torch.einsum("bcihp,bchpn->bcihn", dyc, s_in)
    dx = torch.einsum("bcijh,bcihp->bcjhp", G, dyc)
    dc = torch.einsum("bcijh,bcjhn->bcihn", M, bc) + e[..., None] * dy_s
    db = torch.einsum("bcijh,bcihn->bcjhn", M, cc)
    dcsum = T.sum(dim=3) - T.sum(dim=2) + e * (cc * dy_s).sum(dim=-1)
    ds = dstate.float()
    dxs, dbs, extra = [], [], []
    for k in reversed(range(xc.shape[1])):
        x_ds = torch.einsum("bjhp,bhpn->bjhn", xc[:, k], ds)
        dxs.append(d[:, k, ..., None]
                   * torch.einsum("bjhn,bhpn->bjhp", bc[:, k], ds))
        dbs.append(d[:, k, ..., None] * x_ds)
        s_term = (bc[:, k] * x_ds).sum(dim=-1) * d[:, k]    # (B,Q,H)
        alpha = e[:, k, -1]                                 # (B,H)
        last = alpha * (ds * s_in[:, k]).sum(dim=(-2, -1)) + s_term.sum(dim=1)
        extra.append((s_term, last))
        ds = alpha[..., None, None] * ds + torch.einsum(
            "bih,bihp,bihn->bhpn", e[:, k], dyc[:, k], cc[:, k])
    dx = dx + torch.stack(dxs[::-1], dim=1)
    db = db + torch.stack(dbs[::-1], dim=1)
    s_terms = torch.stack([s for s, _ in extra[::-1]], dim=1)
    lasts = torch.stack([a for _, a in extra[::-1]], dim=1)  # (B,nc,H)
    dcsum = dcsum - s_terms
    dcsum[:, :, -1] += lasts
    # ddA_t = sum of dcsum over u >= t within the chunk
    rev = torch.flip(torch.cumsum(torch.flip(dcsum.double(), (2,)), dim=2),
                     (2,)).float()
    return (unchunk(dx, S), unchunk(rev, S), unchunk(db, S),
            unchunk(dc, S))


def bwd_chunk_parallel_plain(x: Tensor, dA: Tensor, b: Tensor, c: Tensor,
                             chunk_states: Tensor, dy: Tensor,
                             dstate: Tensor, *, chunk: int
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The phases the bf16 backward kernels run, in plain f32 (the
    counterpart of ``bwd_u_kernel``, ``bwd_state_kernel``,
    ``bwd_chunk_kernel`` and ``bwd_ddA_kernel``; nothing calls it on the
    main path):

      1. each chunk's term of the dS recurrence, U_c = (e_c dy_c)^T c_c;
      2. the reverse state pass, the only step sequential over chunks:
         dS_out[nc-1] = dstate, dS_out[c-1] = alpha_c dS_out[c] + U_c;
      3. every chunk's outputs at once, from its S_in and dS_out;
      4. ddA, the chunk-local reverse cumsum (float64, rounded once).

    Same returns as :func:`bwd_plain`."""
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    xc, bc, cc, dyc = (chunked(t, chunk) for t in (x, b, c, dy))
    csum = chunk_csum(chunked(dA, chunk))                   # (B,nc,Q,H)
    e = torch.exp(csum)
    d = torch.exp(csum[:, :, -1:] - csum)
    alpha = e[:, :, -1]                                     # (B,nc,H)
    U = torch.einsum("bcih,bcihp,bcihn->bchpn", e, dyc, cc)
    carry, ds_out = dstate.float(), []
    for k in reversed(range(xc.shape[1])):
        ds_out.append(carry)
        carry = alpha[:, k, :, None, None] * carry + U[:, k]
    ds = torch.stack(ds_out[::-1], dim=1)                   # (B,nc,H,P,N)
    s_in = chunk_states.float().transpose(1, 2)             # (B,nc,H,P,N)
    L = decay_matrix(csum)
    G = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * L
    M = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc) * L
    T = M * torch.einsum("bcihn,bcjhn->bcijh", cc, bc)      # dG * G
    dy_s = torch.einsum("bcihp,bchpn->bcihn", dyc, s_in)
    x_ds = torch.einsum("bcjhp,bchpn->bcjhn", xc, ds)
    dx = torch.einsum("bcijh,bcihp->bcjhp", G, dyc) + d[..., None] * \
        torch.einsum("bcjhn,bchpn->bcjhp", bc, ds)
    dc = torch.einsum("bcijh,bcjhn->bcihn", M, bc) + e[..., None] * dy_s
    db = torch.einsum("bcijh,bcihn->bcjhn", M, cc) + d[..., None] * x_ds
    s_term = (bc * x_ds).sum(dim=-1) * d                    # (B,nc,Q,H)
    dcsum = T.sum(dim=3) - T.sum(dim=2) + e * (cc * dy_s).sum(dim=-1) \
        - s_term
    dcsum[:, :, -1] += alpha * (ds * s_in).sum(dim=(-2, -1)) \
        + s_term.sum(dim=2)
    rev = torch.flip(torch.cumsum(torch.flip(dcsum.double(), (2,)), dim=2),
                     (2,)).float()
    return (unchunk(dx, S), unchunk(rev, S), unchunk(db, S),
            unchunk(dc, S))


_BWD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 14
                 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 27
                 + [ctypes.c_void_p])


def bwd_kernel_layout(x: Tensor, dA: Tensor, b: Tensor, c: Tensor,
                      chunk_states: Tensor, dy: Tensor, dstate: Tensor, *,
                      chunk: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Backward; operands as ``fwd_res_kernel_layout`` plus its
    chunk_states, the output cotangent dy (B,S,H,P) f32 and the
    final-state cotangent dstate (B,H,P,N) f32.  Returns (dx, ddA
    (B,S,H), db, dc), all f32."""
    Bb, S, H, P, N = check_layout(x, dA, b, c, dy)
    nc = n_chunks(S, chunk)
    if tuple(chunk_states.shape) != (Bb, H, nc, P, N) or \
            tuple(dy.shape) != (Bb, S, H, P) or \
            tuple(dstate.shape) != (Bb, H, P, N):
        raise ValueError(f"chunk_states {tuple(chunk_states.shape)}, dy "
                         f"{tuple(dy.shape)}, dstate {tuple(dstate.shape)} "
                         f"do not fit x {tuple(x.shape)} at chunk {chunk}")
    if x.device.type == "cpu":
        return bwd_plain(x, dA, b, c, chunk_states, dy, dstate, chunk=chunk)
    dtype = kernel_dtype_code(x, dA, b, c, P, N, chunk)
    for t in (chunk_states, dy, dstate):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError("chunk_states, dy and dstate must be float32 on "
                             "x's device")
    chunk_states, dstate = chunk_states.contiguous(), dstate.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, S, H, P), **f32)
    ddA = torch.empty((Bb, S, H), **f32)
    db = torch.empty((Bb, S, H, N), **f32)
    dc = torch.empty((Bb, S, H, N), **f32)
    u_scr = img_scr = rows_scr = None
    if x.dtype == torch.bfloat16:   # the chunk-parallel kernels' scratch
        check_aligned("backward", x=x, b=b, c=c, dy=dy)
    if x.device.type == "meta":
        _build.meta_launch("ssd_bwd", ssd_bwd_work, **work_shape(x, b, chunk))
        return dx, ddA, db, dc
    if x.dtype == torch.bfloat16:
        u_scr = torch.empty((Bb, H, nc, P, N), **f32)
        # S_in and dS_out, two bf16 parts each, as 64 x max(N, 64) tiles
        img_scr = torch.empty(Bb * H * nc * 4 * 64 * max(N, 64),
                              dtype=torch.bfloat16, device=x.device)
        rows_scr = torch.empty(
            Bb * H * nc * (2 * chunk + 4 + -(-P * N // 512)), **f32)
    fn = _build.function("ssd_bwd", "ssd_bwd", _BWD_ARGTYPES)
    code = fn(dtype, P, N, x.data_ptr(), dA.data_ptr(), b.data_ptr(),
              c.data_ptr(), chunk_states.data_ptr(), dy.data_ptr(),
              dstate.data_ptr(), dx.data_ptr(), ddA.data_ptr(), db.data_ptr(),
              dc.data_ptr(),
              *(None if t is None else t.data_ptr()
                for t in (u_scr, img_scr, rows_scr)),
              Bb, S, H, chunk, *strides3(x), *strides3(dA),
              *strides3(b), *strides3(c), *strides3(dy), *strides3(dx),
              *strides3(ddA), *strides3(db), *strides3(dc),
              _build.stream_of(x))
    _build.check("ssd_bwd", code)
    bwd_kernel_layout.launches += 1
    return dx, ddA, db, dc


bwd_kernel_layout.launches = 0
