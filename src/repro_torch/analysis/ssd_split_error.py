"""How far the bf16 parts of the SSD kernels' f32 operands move their
outputs: a CPU model of the rounding, not of the card.

    python -m repro_torch.analysis.ssd_split_error

The bf16 forward and backward kernels (``csrc/ssd_fwd.cu``,
``csrc/ssd_bwd.cu``) feed each f32 operand of a tensor-core product as
bf16 parts, x = p1 + p2 (+ p3), part k the bf16 of what parts 1 .. k-1
leave, and sum the products of the parts into one accumulator.  This
module rounds the operands the same way, forms every product in float64
(so only the splitting errs) and reports max|err| / max(max|want|, 1)
against the unsplit float64 products, at mamba2-2.7b's widths (P 64,
N 128, chunk 256) with four heads:
  * the forward's y, final state and chunk states, for the kernels'
    scheme (U = (d x)^T b with d x in three parts, G x with G in three,
    c S_in^T with S_in in two) and for two parts everywhere;
  * the backward's dx, dc and db, for the kernels' scheme (G, dy three
    parts in G^T dy, M three parts) and two parts everywhere with the
    lo x lo products dropped.
The card's own errors are ``chip_smoke.py`` phase 3b's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ssd_bwd
from repro_torch.kernels.ssd import chunk_csum, chunked, decay_matrix

# product: (parts of the first operand, parts of the second, highest order
# kept), order = index sum of the two parts; 0 parts = exact
KERNELS = dict(U=(2, 0, 1), DG=(2, 0, 1), dyS=(2, 2, 1), Gdy=(3, 3, 2),
               bdS=(0, 2, 1), Mb=(3, 0, 2))
TWO_PARTS = dict(KERNELS, Gdy=(2, 2, 1), Mb=(2, 0, 1))
FWD_KERNELS = dict(U=(3, 0, 2), Gx=(3, 0, 2), cS=(0, 2, 1))
FWD_TWO_PARTS = dict(FWD_KERNELS, U=(2, 0, 1), Gx=(2, 0, 1))


def split(t: torch.Tensor, parts: int):
    """t as ``parts`` float64 tensors holding bf16 values (t itself, in
    float64, for 0)."""
    if parts == 0:
        return [t.double()]
    out, rest = [], t.double()
    for _ in range(parts):
        head = rest.float().bfloat16().double()
        out.append(head)
        rest = rest - head
    return out


def product(eq: str, a: torch.Tensor, b: torch.Tensor, scheme) -> torch.Tensor:
    pa, pb, order = scheme
    return sum(torch.einsum(eq, x, y)
               for i, x in enumerate(split(a, pa))
               for j, y in enumerate(split(b, pb)) if i + j <= order)


def forward_outputs(x, dA, b, c, chunk, schemes):
    """(y, final state, chunk states) in float64 with each product split
    as ``schemes`` says (None: no product split).  The forward's phases:
    U = (d x)^T b per chunk, the state pass, then y = G x + e (c S_in^T)."""
    sc = schemes or {k: (0, 0, 0) for k in FWD_KERNELS}
    xc, bc, cc = (chunked(t, chunk) for t in (x, b, c))
    csum = chunk_csum(chunked(dA, chunk))
    e = torch.exp(csum).double()
    d = torch.exp(csum[:, :, -1:] - csum)
    U = product("bcjhp,bcjhn->bchpn", d[..., None] * xc, bc, sc["U"])
    carry, s_in = torch.zeros_like(U[:, 0]), []
    for k in range(U.shape[1]):
        s_in.append(carry)
        carry = e[:, k, -1, :, None, None] * carry + U[:, k]
    s_in = torch.stack(s_in, 1).float()
    G = (torch.einsum("bcihn,bcjhn->bcijh", cc.double(), bc.double())
         * decay_matrix(csum).double()).float()
    y = product("bcijh,bcjhp->bcihp", G, xc, sc["Gx"]) + e[..., None] \
        * product("bcihn,bchpn->bcihp", cc, s_in, sc["cS"])
    return y, carry, s_in


def outputs(x, dA, b, c, chunk_states, dy, dstate, chunk, schemes):
    """(dx, dc, db) in float64 with each product split as ``schemes`` says
    (None: no product split)."""
    exact = {k: (0, 0, 0) for k in KERNELS}
    sc = schemes or exact
    xc, bc, cc, dyc = (chunked(t, chunk) for t in (x, b, c, dy))
    csum = chunk_csum(chunked(dA, chunk))
    e = torch.exp(csum).double()
    d = torch.exp(csum[:, :, -1:] - csum).double()
    L = decay_matrix(csum).double()
    U = product("bcihp,bcihn->bchpn", (e[..., None] * dyc).float(), cc, sc["U"])
    carry, ds = dstate.double(), []
    for k in reversed(range(U.shape[1])):
        ds.append(carry)
        carry = e[:, k, -1, :, None, None] * carry + U[:, k]
    ds = torch.stack(ds[::-1], 1).float()
    s_in = chunk_states.transpose(1, 2)
    G = (torch.einsum("bcihn,bcjhn->bcijh", cc.double(), bc.double())
         * L).float()
    M = (product("bcihp,bcjhp->bcijh", dyc, xc, sc["DG"]) * L).float()
    dx = product("bcijh,bcihp->bcjhp", G, dyc, sc["Gdy"]) + d[..., None] \
        * product("bcjhn,bchpn->bcjhp", bc, ds, sc["bdS"])
    dc = product("bcijh,bcjhn->bcihn", M, bc, sc["Mb"]) + e[..., None] \
        * product("bcihp,bchpn->bcihn", dyc, s_in, sc["dyS"])
    db = product("bcijh,bcihn->bcjhn", M, cc, sc["Mb"]) + d[..., None] \
        * product("bcjhp,bchpn->bcjhn", xc, ds, sc["bdS"])
    return dx, dc, db


def rel_errs(got, want, names) -> dict:
    """{name: max|got - want| / max(max|want|, 1)}, the card's measure."""
    return {k: float((g - w).abs().max() / max(float(w.abs().max()), 1.))
            for k, g, w in zip(names, got, want)}


def inputs(seed: int = 0, B=1, S=2048, H=4, P=64, N=128):
    """x, dA, b, c (bf16 x, b, c; b and c one group broadcast over the
    heads, as mamba2-2.7b's), dy, dstate, drawn as the card's tests do."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen)
    x = rnd(B, S, H, P).bfloat16()
    b, c = (rnd(B, S, 1, N).bfloat16().expand(B, S, H, N) for _ in "bc")
    dA = -(torch.rand((B, S, H), generator=gen) * 1.95 + 0.05)
    return x, dA, b, c, rnd(B, S, H, P), rnd(B, H, P, N)


def forward_errors(x, dA, b, c, chunk, scheme) -> dict:
    """The forward's errors under ``scheme`` against the unsplit float64
    products: {"y": .., "state": .., "chunk_states": ..}."""
    names = ("y", "state", "chunk_states")
    return rel_errs(forward_outputs(x, dA, b, c, chunk, scheme),
                    forward_outputs(x, dA, b, c, chunk, None), names)


def main(seed: int = 0) -> None:
    chunk = 256
    x, dA, b, c, dy, dstate = inputs(seed)
    for name, scheme in (("kernels", FWD_KERNELS),
                         ("two parts", FWD_TWO_PARTS)):
        errs = forward_errors(x, dA, b, c, chunk, scheme)
        print(f"forward  {name:11s} " + " ".join(
            f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    _, _, cs = ssd_bwd.fwd_res_plain(x, dA, b, c, chunk=chunk)
    want = outputs(x, dA, b, c, cs, dy, dstate, chunk, None)
    for name, scheme in (("kernels", KERNELS), ("two parts", TWO_PARTS)):
        got = outputs(x, dA, b, c, cs, dy, dstate, chunk, scheme)
        errs = rel_errs(got, want, ("dx", "dc", "db"))
        print(f"backward {name:11s} " + " ".join(
            f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


if __name__ == "__main__":
    main()
