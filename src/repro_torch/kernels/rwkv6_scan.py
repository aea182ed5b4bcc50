"""The chunked RWKV-6 WKV, forward (K5) and backward (K5b): each a wrapper
around hand-written CUDA kernels beside its plain PyTorch version.

* :func:`wkv6_chunked_plain` computes the reference's ``repro.models.
  rwkv6.wkv6_chunked`` in torch, with the carry over chunks as a Python
  loop, without its overflow (below).
* :func:`wkv6_backward_plain` is its gradient by autograd, with the final
  state's cotangent zero.
* :func:`rwkv6_wkv_fwd` (K5) returns ``(o, s_final)``; its kernels
  (``csrc/rwkv6_scan.cu``: ``wkv_chunk_state``, ``chunk_carry``,
  ``wkv_chunk_out``) replace the Pallas ``rwkv6_wkv`` / ``_kernel`` of
  ``src/repro/kernels/rwkv6_scan.py`` and, on the training and prefill
  paths, the XLA ``wkv6_chunked``.
* :func:`rwkv6_wkv_bwd` (K5b) returns ``(dr, dk, dv, dw, du)``; the JAX
  package takes that gradient from XLA autodiff.

Shapes: ``r, k, v [B,L,H,hd]`` in the compute dtype, ``w [B,L,H,hd]``
float32 in (0, 1), ``u [H,hd]`` float32. ``o [B,L,H,hd]`` in r's dtype and
the final state ``[B,H,hd,hd]`` float32, ``s[h, c_k, c_v]``. The chunk is
``min(64, L)`` and L must be a multiple of it. All arithmetic is float32.

Within a chunk ``cs`` is the running sum of ``log(clip(w, 1e-6, 1))`` per
key channel (``cs[-1]`` the chunk's whole decay) and ``cp[t] = cs[t-1]``
(0 at t = 0). Every decay formed is ``exp(cp[t] - cs[s])`` for s < t,
``exp(cs[-1] - cs[s])`` or ``exp(cp[t])``, each at most 1. The reference
instead forms ``k * exp(-cs)`` and ``r * exp(cp)`` and multiplies them:
``exp(-cs)`` overflows float32 once a chunk's decay passes e^88 (w = 0.2
over 64 tokens), and before that the product of a huge and a tiny factor
loses its digits (w = 0.25: outputs off by about 4-5). The decay of the
model (``exp(-exp(.))``) reaches such w whenever its exponent passes 0.2.

The kernels take the carried ``[hd,hd]`` state (the Pallas grid's VMEM
scratch, walked chunk after chunk) in three launches that fill the card: a
parallel pass over (row, head, chunk) for each chunk's own state and its
decay, a carry over chunks that streams each state element through them
(the decay a vector over the key channel), and a parallel pass for the
outputs. Within a chunk every product runs on the tensor cores in split
TF32. The pairwise decays ``exp(cp[t] - cs[s])`` differ per channel, so
the scores are no plain product: the chunk is cut into blocks of 16 rows
(:func:`plan`), and for a block of rows t above a block of rows s the
decay factors around reference points (cs at the row before the t-block
and at the s-block's last row) into factors of at most 1, on r, on k and
per channel, which makes the block a product; only the diagonal blocks
keep one exponential per (t, s, channel). K5b
recomputes the carried states, runs the state cotangent backwards over
chunks in the same launch, and takes ``du`` from per-chunk partials
summed in a fixed order, so the gradient is deterministic. Bounds on an
H100 are in ``csrc/rwkv6_scan.cu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

CHUNK = 64
CLIP = 1e-6                  # the reference's clip of w before its log
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 64                  # the kernels' largest head width
BLOCK = 16                   # rows of a sub-block of the chunk


def _chunk(L: int, chunk: int = CHUNK) -> int:
    c = min(chunk, L)
    if L % c:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {c}")
    return c


def wkv6_chunked_plain(r, k, v, w, u, s0=None, chunk: int = CHUNK):
    """The reference's ``wkv6_chunked`` without its overflow: r, k, v, w
    [b,l,h,d] (w in (0,1)), u [h,d], s0 [b,h,d,d] (zeros if None) ->
    (o [b,l,h,d] in r's dtype, s_final [b,h,d,d] float32).
    Differentiable by autograd."""
    b, l, h, d = r.shape
    c = _chunk(l, chunk)
    nc = l // c
    rr, kk, vv = (t.reshape(b, nc, c, h, d).float() for t in (r, k, v))
    lw = torch.log(w.float().clamp(CLIP, 1.0)).reshape(b, nc, c, h, d)
    cs = torch.cumsum(lw, dim=2)                               # inclusive
    cp = torch.cat([torch.zeros_like(cs[:, :, :1]), cs[:, :, :-1]], dim=2)
    # exp(cp[t] - cs[s]) for s < t, [b,nc,t,s,h,d]: masked before the
    # exponential (for s >= t the exponent may be positive and overflow)
    tri = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    diff = cp[:, :, :, None] - cs[:, :, None, :]
    decay = torch.exp(torch.where(tri[:, :, None, None], diff,
                                  float("-inf")))
    att = torch.einsum("bzthd,bztshd->bzhts", rr,
                       decay * kk[:, :, None])
    bonus = (rr * u.float() * kk).sum(-1)                      # [b,nc,c,h]
    o = torch.einsum("bzhts,bzshd->bzthd", att, vv) + bonus[..., None] * vv
    kd = kk * torch.exp(cs[:, :, -1:] - cs)                    # k to chunk end
    states = torch.einsum("bzshi,bzshj->bzhij", kd, vv)
    g = torch.exp(cs[:, :, -1])                                # [b,nc,h,d]
    s = (torch.zeros(b, h, d, d, dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * g[:, z, :, :, None] + states[:, z]
    s_prevs = torch.stack(s_prevs, dim=1)                      # [b,nc,h,d,d]
    o = o + torch.einsum("bzthi,bzhij->bzthj", rr * torch.exp(cp), s_prevs)
    return o.reshape(b, l, h, d).to(r.dtype), s


def wkv6_backward_plain(r, k, v, w, u, do, chunk: int = CHUNK):
    """(dr, dk, dv, dw, du) of :func:`wkv6_chunked_plain` for the output
    cotangent ``do`` (the final state's is zero), by torch autograd; each
    in its input's dtype. w's gradient passes through ``log(clip(w, 1e-6,
    1))`` as the reference's does: zero where w lies outside the clip."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        o, _ = wkv6_chunked_plain(*ins, chunk=chunk)
        return torch.autograd.grad(o, ins, do)


def _check(r, k, v, w, u, extra=()):
    """What the kernels take: r, k, v [B,L,H,hd] float32 or bfloat16 of
    one dtype, w [B,L,H,hd] and u [H,hd] float32, hd at most 64, L a
    multiple of its chunk, every tensor contiguous on r's device. Returns
    (B, L, H, hd, chunk)."""
    if r.dim() != 4:
        raise ValueError(f"r [B,L,H,hd] expected, got {tuple(r.shape)}")
    B, L, H, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, hd):
        raise ValueError(f"k, v, w [B,L,H,hd] and u [H,hd] expected for r "
                         f"{tuple(r.shape)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}")
    if hd > MAX_HD:
        raise ValueError(f"kernel takes hd up to {MAX_HD}, got {hd}")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"r, k and v must be one of float32 and bfloat16, "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"w and u must be float32, got {w.dtype}, "
                        f"{u.dtype}")
    tensors = (r, k, v, w, u) + tuple(extra)
    if any(t.device != r.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    return B, L, H, hd, _chunk(L)


class Plan(NamedTuple):
    """How the kernels cut one call: the chunk, its sub-blocks of BLOCK
    rows (the last may be shorter), the ``grid`` of the per-chunk kernels
    (chunks, heads, B), and the shapes of the scratch the wrappers
    allocate."""
    chunk: int
    blocks: int
    grid: tuple
    states: tuple       # carried states (and cotangents) per chunk
    decays: tuple       # exp(cs_last) per (row, head, chunk, key channel)
    cs: tuple           # the running sums of log w, for the chunk kernels
    du_part: tuple      # du's partial per (head, row, chunk)


def plan(B: int, L: int, H: int, hd: int) -> Plan:
    """One CTA per (chunk, head, row) of the chunk kernels; a chunk of c
    positions is ceil(c / 16) sub-blocks, each taken by one warp."""
    c = _chunk(L)
    nc = L // c
    return Plan(c, -(-c // BLOCK), (nc, H, B), (B, H, nc, hd, hd),
                (B, H, nc, hd), (B, L, H, hd), (H, B, nc, hd))


def rwkv6_wkv_fwd(r, k, v, w, u):
    """The WKV forward, same contract as :func:`wkv6_chunked_plain`
    without ``s0``. CPU tensors take the plain version; CUDA tensors
    launch the kernels, or raise on what they do not take.
    ``rwkv6_wkv_fwd.launches`` counts calls that launch."""
    if r.device.type == "cpu":
        return wkv6_chunked_plain(r, k, v, w, u)
    B, L, H, hd, c = _check(r, k, v, w, u)
    pl = plan(B, L, H, hd)
    f32 = dict(dtype=torch.float32, device=r.device)
    o = torch.empty_like(r)
    s_fin = torch.empty((B, H, hd, hd), **f32)
    # scratch: each chunk's own state (then the state entering it), its
    # decay exp(cs[-1]) per key channel, and cs
    states = torch.empty(pl.states, **f32)
    decays = torch.empty(pl.decays, **f32)
    cs = torch.empty(pl.cs, **f32)
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_wkv_fwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), s_fin.data_ptr(), states.data_ptr(),
            decays.data_ptr(), cs.data_ptr(), B, L, H, hd, c,
            _DTYPE_CODE[r.dtype], stream)
    _build.check(err, "rwkv6_wkv_fwd")
    rwkv6_wkv_fwd.launches += 1
    return o, s_fin


rwkv6_wkv_fwd.launches = 0


def rwkv6_wkv_bwd(r, k, v, w, u, do):
    """The WKV backward, same contract as :func:`wkv6_backward_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernels,
    or raise on what they do not take. ``rwkv6_wkv_bwd.launches`` counts
    calls that launch."""
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, do)
    B, L, H, hd, c = _check(r, k, v, w, u, (do,))
    if do.shape != r.shape or do.dtype != r.dtype:
        raise ValueError(f"do must match r {tuple(r.shape)} {r.dtype}, got "
                         f"{tuple(do.shape)} {do.dtype}")
    pl = plan(B, L, H, hd)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty((B, L, H, hd), **f32)
    du = torch.empty((H, hd), **f32)
    # scratch: carried states and state cotangents per chunk, the chunks'
    # decays, cs, per-chunk partials of du
    states = torch.empty(pl.states, **f32)
    gstates = torch.empty(pl.states, **f32)
    decays = torch.empty(pl.decays, **f32)
    cs = torch.empty(pl.cs, **f32)
    du_part = torch.empty(pl.du_part, **f32)
    lib = _build.library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_wkv_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), states.data_ptr(),
            gstates.data_ptr(), decays.data_ptr(), cs.data_ptr(),
            du_part.data_ptr(), B, L, H, hd, c, _DTYPE_CODE[r.dtype], stream)
    _build.check(err, "rwkv6_wkv_bwd")
    rwkv6_wkv_bwd.launches += 1
    return dr, dk, dv, dw, du


rwkv6_wkv_bwd.launches = 0
