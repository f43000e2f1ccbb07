"""Mamba-2 SSD chunked scan, forward: the Hopper kernels' wrapper and its
plain versions (counterpart of ``repro/kernels/ssd.py``).

The kernels (``csrc/ssd_fwd.cu``, entry ``ssd_fwd``) replace the Pallas
``_ssd_kernel``.  Within a chunk of Q positions, with csum = cumsum(dA)
restarting at every chunk:

    L[i,j] = exp(csum_i - csum_j) for i >= j, else 0
    y      = ((c b^T) * L) x + exp(csum)[:,None] * (c S^T)
    S'     = exp(csum[-1]) S + x^T (b * exp(csum[-1] - csum)[:,None])

In f32 one block per (batch, head) walks the chunks in order with the
(P, N) state in shared memory.  In bf16 the walk is split into
chunk-parallel phases on the tensor cores, which
:func:`fwd_chunk_parallel_plain` spells out: each chunk's term of the
state recurrence, the state pass, then every chunk's outputs at once.

Layout: the public (B, S, H, .) tensors go in as they are, addressed by
their batch, sequence and head strides (unit stride on the last dim), so
B and C broadcast over heads with a head stride of 0 cost no copy.  A
sequence that is not a whole number of chunks ends in a short chunk whose
missing positions count as zero inputs with zero log-decay (the JAX op's
padding convention), so no padding is materialized.

Rounding: csum is accumulated in float64 and rounded once to float32, in
the kernels and in the plain versions alike, so both build the same decay
matrix.  (A float32 running sum over a 256-long chunk drifts by ~1e-4 at
|csum| ~ 250, which would move ``L`` near the diagonal by as much.)

Dispatch: a CPU tensor takes :func:`ssd_fwd_plain`; a CUDA tensor launches
the kernels or raises; in a dry run a meta tensor passes the same checks
and reports its launch's :func:`ssd_fwd_work` (``_build.meta_launch``).
``ssd_fwd_kernel_layout.launches`` counts calls that launched them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (P, N) = (head_dim, d_state) the kernels are built for: mamba2-2.7b and
# mamba2-reduced.
SHAPES = ((64, 128), (16, 16))
MAX_CHUNK = 256


def check_layout(x: Tensor, dA: Tensor, b: Tensor, c: Tensor,
                 *others: Tensor) -> Tuple[int, int, int, int, int]:
    """Validate x (B, S, H, P), dA (B, S, H), b and c (B, S, H, N) on one
    device, unit stride on the last dim.  Returns (B, S, H, P, N)."""
    if x.dim() != 4 or dA.dim() != 3 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"expected x (B,S,H,P), dA (B,S,H), b/c (B,S,H,N), "
                         f"got {tuple(x.shape)}, {tuple(dA.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    Bb, S, H, P = x.shape
    N = b.shape[-1]
    if tuple(dA.shape) != (Bb, S, H) or tuple(b.shape[:3]) != (Bb, S, H):
        raise ValueError(f"incompatible SSD shapes {tuple(x.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(b.shape)}")
    for t in (dA, b, c) + others:
        if t.device != x.device:
            raise ValueError("SSD operands must share a device")
    for t in (x, b, c) + others:
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError("SSD operands need a unit stride on the last dim")
    return Bb, S, H, P, N


def kernel_dtype_code(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, P: int,
                      N: int, chunk: int) -> int:
    """The kernels' dtype code for x, b and c; raises for what they do not
    take (another device, dtype, (P, N) or chunk; on the meta device, what
    they would not)."""
    _build.kernel_device(x, "SSD")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype \
            or dA.dtype != torch.float32:
        raise ValueError(f"SSD kernels take x, b, c in one of float32 or "
                         f"bfloat16 and float32 dA, got {x.dtype}, {b.dtype}, "
                         f"{c.dtype}, {dA.dtype}")
    if (P, N) not in SHAPES or not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"SSD kernels take (P, N) in {SHAPES} and chunk <= "
                         f"{MAX_CHUNK}, got ({P}, {N}), chunk {chunk}")
    return _DTYPES[x.dtype]


def strides3(t: Tensor):
    """Batch, sequence and head strides."""
    return t.stride(0), t.stride(1), t.stride(2)


def n_chunks(S: int, chunk: int) -> int:
    return -(-S // chunk)


def work_shape(x: Tensor, b: Tensor, chunk: int) -> dict:
    """The work functions' arguments for a call on x (B, S, H, P) and b
    (B, S, H, N): b's (and c's) heads count once when they broadcast one
    group (head stride 0)."""
    Bb, S, H, P = x.shape
    return dict(B=Bb, S=S, H=H, P=P, N=b.shape[-1], chunk=chunk,
                itemsize=x.element_size(), groups=1 if b.stride(2) == 0 else H)


def work_terms(B, S, H, P, N, chunk, itemsize, groups):
    """(causal pairs within chunks, one Q x P x N product over all chunks,
    the bytes of x, dA and the ``groups`` heads of b and c, chunks)."""
    nc = n_chunks(S, chunk)
    pairs = chunk * (chunk + 1) // 2 * nc * B * H
    qpn = 2.0 * chunk * P * N * nc * B * H
    ins = itemsize * (B * S * H * P + 2 * B * S * groups * N) + 4 * B * S * H
    return pairs, qpn, ins, nc


def ssd_fwd_work(*, B, S, H, P, N, chunk, itemsize, groups
                 ) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_fwd`` launch: the chunked scan, which
    writes f32 y and the final state."""
    pairs, qpn, ins, _ = work_terms(B, S, H, P, N, chunk, itemsize, groups)
    return (2.0 * pairs * (N + P) + 2 * qpn,
            ins + 4 * (B * S * H * P + B * H * P * N))


def ssd_fwd_res_work(*, B, S, H, P, N, chunk, itemsize, groups
                     ) -> Tuple[float, float]:
    """(flops, bytes) of one ``ssd_fwd_res`` launch: the scan that also
    writes each chunk's entering state."""
    flops, nbytes = ssd_fwd_work(B=B, S=S, H=H, P=P, N=N, chunk=chunk,
                                 itemsize=itemsize, groups=groups)
    return flops, nbytes + 4 * B * H * n_chunks(S, chunk) * P * N


def check_aligned(kernel: str, **ts: Tensor) -> None:
    """The bf16 kernels copy 16-byte chunks of their operands: each must
    start 16-byte aligned, with batch, sequence and head strides that are
    multiples of 16 bytes.  Raises otherwise."""
    for t in ts.values():
        mult = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % mult for st in strides3(t)):
            raise ValueError(f"the bf16 SSD {kernel} needs {', '.join(ts)} "
                             f"16-byte aligned with batch, sequence and head "
                             f"strides that are multiples of 16 bytes")


# ---------------------------------------------------------------------------
# Plain version (shared with ssd_bwd)
# ---------------------------------------------------------------------------

def chunked(t: Tensor, chunk: int) -> Tensor:
    """(B, S, H, ...) -> (B, nc, Q, H, ...) f32, the tail zero-padded."""
    S = t.shape[1]
    pad = n_chunks(S, chunk) * chunk - S
    t = t.float()
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape((t.shape[0], -1, chunk) + tuple(t.shape[2:]))


def unchunk(t: Tensor, S: int) -> Tensor:
    """(B, nc, Q, H, ...) -> (B, S, H, ...)."""
    return t.reshape((t.shape[0], -1) + tuple(t.shape[3:]))[:, :S]


def chunk_csum(dAc: Tensor) -> Tensor:
    """Per-chunk inclusive cumsum over Q of (B, nc, Q, H), accumulated in
    float64 and rounded once to float32, as the kernels do."""
    return torch.cumsum(dAc.double(), dim=2).float()


def decay_matrix(csum: Tensor) -> Tensor:
    """L (B, nc, Q, Q, H): L[i,j] = exp(csum_i - csum_j) for i >= j."""
    Q = csum.shape[2]
    diff = csum[:, :, :, None] - csum[:, :, None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=csum.device).tril()
    return torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)


def ssd_fwd_plain(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, *,
                  chunk: int, with_states: bool = False):
    """Plain version of the forward kernels: the same f32 arithmetic, the
    chunks walked in order.  Returns (y (B,S,H,P), final state (B,H,P,N))
    plus chunk_states (B,H,nc,P,N), the state entering each chunk, when
    ``with_states``; all f32."""
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    xc, bc, cc = chunked(x, chunk), chunked(b, chunk), chunked(c, chunk)
    csum = chunk_csum(chunked(dA, chunk))                   # (B,nc,Q,H)
    G = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * decay_matrix(csum)
    y = torch.einsum("bcijh,bcjhp->bcihp", G, xc)
    e = torch.exp(csum)
    d = torch.exp(csum[:, :, -1:] - csum)
    upd = torch.einsum("bcjhp,bcjhn->bchpn", xc, bc * d[..., None])
    state = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    states, inter = [], []
    for k in range(xc.shape[1]):
        states.append(state)
        inter.append(torch.einsum("bihn,bhpn->bihp", cc[:, k], state))
        state = state * e[:, k, -1][..., None, None] + upd[:, k]
    y = y + e[..., None] * torch.stack(inter, dim=1)
    y = unchunk(y, S)
    if with_states:
        return y, state, torch.stack(states, dim=2)
    return y, state


def fwd_chunk_parallel_plain(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, *,
                             chunk: int, with_states: bool = False):
    """The phases the bf16 forward kernels run, in plain f32 (the
    counterpart of ``fwd_u_kernel``, ``fwd_state_kernel`` and
    ``fwd_chunk_kernel``; nothing calls it on the main path):

      1. each chunk's term of the state recurrence,
         U_k = (d_k x_k)^T b_k with d = exp(csum[-1] - csum);
      2. the state pass, the only step sequential over chunks:
         S_in[0] = 0, S_in[k+1] = exp(csum_k[-1]) S_in[k] + U_k;
      3. every chunk's outputs at once from its S_in:
         y = ((c b^T) * L) x + exp(csum) (c S_in^T).

    Same returns as :func:`ssd_fwd_plain`."""
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    xc, bc, cc = chunked(x, chunk), chunked(b, chunk), chunked(c, chunk)
    csum = chunk_csum(chunked(dA, chunk))                   # (B,nc,Q,H)
    e = torch.exp(csum)
    d = torch.exp(csum[:, :, -1:] - csum)
    U = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", d, xc, bc)
    carry, s_in = torch.zeros_like(U[:, 0]), []
    for k in range(U.shape[1]):
        s_in.append(carry)
        carry = e[:, k, -1, :, None, None] * carry + U[:, k]
    s_in = torch.stack(s_in, dim=1)                         # (B,nc,H,P,N)
    G = torch.einsum("bcihn,bcjhn->bcijh", cc, bc) * decay_matrix(csum)
    y = torch.einsum("bcijh,bcjhp->bcihp", G, xc) + e[..., None] * \
        torch.einsum("bcihn,bchpn->bcihp", cc, s_in)
    y = unchunk(y, S)
    if with_states:
        return y, carry, s_in.transpose(1, 2)
    return y, carry


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

FWD_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 15
                + [ctypes.c_void_p])


def launch_fwd(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, chunk: int,
               chunk_states: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Launch ``ssd_fwd`` (``chunk_states`` None) or ``ssd_fwd_res`` (it
    is the (B,H,nc,P,N) f32 output, contiguous).  bf16 operands must be
    16-byte aligned (:func:`check_aligned`) and take about 84 MB of
    scratch a call at mamba2-2.7b's shape.  Returns (y, state)."""
    Bb, S, H, P, N = check_layout(x, dA, b, c)
    dtype = kernel_dtype_code(x, dA, b, c, P, N, chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    scratch = (None, None, None)
    if x.dtype == torch.bfloat16:   # the chunk-parallel kernels' scratch
        check_aligned("forward", x=x, b=b, c=c)
        nc = n_chunks(S, chunk)
        scratch = (torch.empty((Bb, H, nc, P, N), **f32),     # U
                   # S_in in two bf16 parts, as 64 x max(N, 64) tiles
                   torch.empty(Bb * H * nc * 2 * 64 * max(N, 64),
                               dtype=torch.bfloat16, device=x.device),
                   torch.empty((Bb, H, nc, chunk), **f32))    # csum
    y = torch.empty((Bb, S, H, P), **f32)
    state = torch.empty((Bb, H, P, N), **f32)
    name = "ssd_fwd" if chunk_states is None else "ssd_fwd_res"
    if x.device.type == "meta":
        _build.meta_launch(name, ssd_fwd_work if chunk_states is None
                           else ssd_fwd_res_work, **work_shape(x, b, chunk))
        return y, state
    fn = _build.function("ssd_fwd", name, FWD_ARGTYPES)
    code = fn(dtype, P, N, x.data_ptr(), dA.data_ptr(), b.data_ptr(),
              c.data_ptr(), y.data_ptr(), state.data_ptr(),
              *(None if t is None else t.data_ptr()
                for t in (chunk_states,) + scratch),
              Bb, S, H, chunk, *strides3(x), *strides3(dA), *strides3(b),
              *strides3(c), *strides3(y), _build.stream_of(x))
    _build.check("ssd_fwd", code)
    return y, state


def ssd_fwd_kernel_layout(x: Tensor, dA: Tensor, b: Tensor, c: Tensor, *,
                          chunk: int) -> Tuple[Tensor, Tensor]:
    """Forward scan.  x: (B, S, H, P); dA: (B, S, H) f32; b, c:
    (B, S, H, N), any strides with a unit last one.  Returns (y (B,S,H,P)
    f32, final state (B,H,P,N) f32)."""
    if x.device.type == "cpu":
        return ssd_fwd_plain(x, dA, b, c, chunk=chunk)
    out = launch_fwd(x, dA, b, c, chunk, None)
    if x.device.type == "cuda":
        ssd_fwd_kernel_layout.launches += 1
    return out


ssd_fwd_kernel_layout.launches = 0
