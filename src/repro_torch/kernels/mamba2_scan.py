"""The chunked Mamba2 SSD scan, forward (K4) and backward (K4b): each a
wrapper around hand-written CUDA kernels beside its plain PyTorch version.

* :func:`ssd_chunked_plain` is the reference's ``repro.models.mamba2.
  ssd_chunked`` in torch, with the carry over chunks as a Python loop.
* :func:`ssd_backward_plain` is its gradient by autograd, with the final
  state's cotangent zero.
* :func:`mamba2_ssd_fwd` (K4) returns ``(y, s_final)``; its kernels
  (``csrc/mamba2_scan.cu``: ``ssd_chunk_state``, ``chunk_carry``,
  ``ssd_chunk_out``) replace the Pallas ``mamba2_ssd`` / ``_kernel`` of
  ``src/repro/kernels/mamba2_scan.py`` and, on the training and prefill
  paths, the XLA ``ssd_chunked``.
* :func:`mamba2_ssd_bwd` (K4b) returns ``(dx, ddt, dA, dBm, dCm)``; the
  JAX package takes that gradient from XLA autodiff.

Shapes (ngroups = 1): ``x [B,L,H,P]`` in the compute dtype, ``dt [B,L,H]``
float32 (positive, after softplus), ``A [H]`` float32 (negative), ``Bm``
and ``Cm [B,L,N]`` float32, shared by all heads. ``y [B,L,H,P]`` in x's
dtype and the final state ``[B,H,N,P]`` float32. The chunk is ``min(64,
L)`` and L must be a multiple of it. The plain versions compute in float32,
as the reference; within a chunk ``cs`` is the running sum of ``dt * A``,
and the decay ``exp(cs_i - cs_j)`` is formed only for ``j <= i`` (masked
before the exponential: for ``j > i`` it could overflow, and inf * 0 is
NaN).

The kernels take the carried ``[N,P]`` state (the Pallas grid's VMEM
scratch, walked chunk after chunk by one program per head) in three
launches that fill the card: a parallel pass over (row, chunk, head group)
for each chunk's own state contribution, a streaming pass over chunks per
state element for the carried states, and a parallel pass for the outputs.
Their products run on the tensor cores in split TF32 (each f32 operand as
a tf32 high and low part, three products; a bf16 x or dy is exact in tf32
and takes fewer), which holds the f32 reference's accuracy where one tf32
product does not. A CTA takes one chunk for a group of heads
(:func:`plan`): it loads the chunk's Bm and Cm once and forms their scores
``C B^T`` once for the group. K4b recomputes the carried states (it does
not keep K4's: 84 MB a layer and microbatch at zamba2's shape), runs the
state cotangent backwards over chunks in the same launch, and reduces
``dBm`` and ``dCm`` over the heads from one partial per head group (summed
in registers over the group's heads) and ``dA`` from per-(head, chunk)
partials in a second pass, without atomics, so the gradient is
deterministic. Design notes and bounds on an H100 are in
``csrc/mamba2_scan.cu`` and ``csrc/tf32_tiles.cuh``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

CHUNK = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_NP = 64          # the kernels' largest state and head width
GROUPS = (8, 4, 2)   # heads to a CTA, largest first (kernels take any)


def _chunk(L: int, chunk: int = CHUNK) -> int:
    c = min(chunk, L)
    if L % c:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {c}")
    return c


def ssd_chunked_plain(x, dt, A, Bm, Cm, s0=None, chunk: int = CHUNK):
    """The reference's ``ssd_chunked``: x [b,l,h,p], dt [b,l,h], A [h],
    Bm/Cm [b,l,n], s0 [b,h,n,p] (zeros if None) -> (y [b,l,h,p] in x's
    dtype, s_final [b,h,n,p] float32). Differentiable by autograd."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = _chunk(l, chunk)
    nc = l // c
    xc = x.reshape(b, nc, c, h, p).float()
    dtc = dt.reshape(b, nc, c, h).float()
    Bc = Bm.reshape(b, nc, c, n).float()
    Cc = Cm.reshape(b, nc, c, n).float()
    dA_cs = torch.cumsum(dtc * A.float(), dim=2)               # [b,nc,c,h]
    ss = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]     # [b,nc,i,j,h]
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    Lm = torch.exp(torch.where(tri[None, None, :, :, None], ss,
                               float("-inf")))
    scores = torch.einsum("bzin,bzjn->bzij", Cc, Bc)
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bzij,bzijh,bzjhp->bzihp", scores, Lm, xdt)
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)      # [b,nc,c,h]
    states = torch.einsum("bzcn,bzch,bzchp->bzhnp", Bc, decay_states * dtc,
                          xc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                # [b,nc,h]
    s = (torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
         if s0 is None else s0.float())
    s_prevs = []
    for z in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + states[:, z]
    s_prevs = torch.stack(s_prevs, dim=1)                      # [b,nc,h,n,p]
    y_off = torch.einsum("bzcn,bzch,bzhnp->bzchp", Cc, torch.exp(dA_cs),
                         s_prevs)
    y = (y_diag + y_off).reshape(b, l, h, p).to(x.dtype)
    return y, s


def ssd_backward_plain(x, dt, A, Bm, Cm, dy, chunk: int = CHUNK):
    """(dx, ddt, dA, dBm, dCm) of :func:`ssd_chunked_plain` for the output
    cotangent ``dy`` (the final state's is zero), by torch autograd; each
    in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        y, _ = ssd_chunked_plain(*ins, chunk=chunk)
        return torch.autograd.grad(y, ins, dy)


def _check(x, dt, A, Bm, Cm, extra=()):
    """What the kernels take: x [B,L,H,P] float32 or bfloat16, dt [B,L,H],
    A [H], Bm and Cm [B,L,N] float32, N and P at most 64, L a multiple of
    its chunk, every tensor contiguous on x's device. Returns (B, L, H, P,
    N, chunk)."""
    if x.dim() != 4:
        raise ValueError(f"x [B,L,H,P] expected, got {tuple(x.shape)}")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, L, H) or A.shape != (H,) or Bm.shape != (B, L, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"dt [B,L,H], A [H], Bm/Cm [B,L,N] expected for x "
                         f"{tuple(x.shape)}, got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if P > MAX_NP or N > MAX_NP:
        raise ValueError(f"kernel takes P and N up to {MAX_NP}, got P={P} "
                         f"N={N}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, Bm, Cm)):
        raise TypeError("dt, A, Bm and Cm must be float32")
    tensors = (x, dt, A, Bm, Cm) + tuple(extra)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    return B, L, H, P, N, _chunk(L)


class Plan(NamedTuple):
    """How the kernels cut one call: ``group`` heads to a CTA (one chunk
    each), the ``grid`` of the per-chunk kernels (chunks, head groups, B),
    and the shapes of the scratch the wrappers allocate."""
    chunk: int
    group: int
    grid: tuple
    states: tuple       # carried states (and cotangents) per chunk
    decay: tuple        # exp(cs_last) per (row, head, chunk)
    parts: tuple        # dBm and dCm partials, one per head group
    dA_part: tuple


def plan(B: int, L: int, H: int, P: int, N: int, sms: int) -> Plan:
    """The head group is the largest of GROUPS that still gives the
    backward's chunk kernel (one CTA per SM) two CTAs for each of the
    card's ``sms`` SMs: zamba2's training shape (B 1, L 4096, H 80) takes
    8 heads, 640 CTAs, on an H100's 132. Larger groups share a chunk's
    Bm/Cm tiles and scores among more heads and write fewer partials, but
    leave SMs idle in the last wave; short sequences (one chunk) take
    groups of 2, one head to each of a CTA's two teams."""
    c = _chunk(L)
    nc = L // c
    group = next((g for g in GROUPS if B * nc * -(-H // g) >= 2 * sms),
                 GROUPS[-1])
    ngroups = -(-H // group)
    return Plan(c, group, (nc, ngroups, B), (B, H, nc, N, P), (B, H, nc),
                (B, ngroups, L, N), (H, B, nc))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mamba2_ssd_fwd(x, dt, A, Bm, Cm):
    """The SSD scan forward, same contract as :func:`ssd_chunked_plain`
    without ``s0``. CPU tensors take the plain version; CUDA tensors
    launch the kernels, or raise on what they do not take.
    ``mamba2_ssd_fwd.launches`` counts calls that launch."""
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, Bm, Cm)
    B, L, H, P, N, c = _check(x, dt, A, Bm, Cm)
    pl = plan(B, L, H, P, N, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    s_fin = torch.empty((B, H, N, P), **f32)
    states = torch.empty(pl.states, **f32)
    decay = torch.empty(pl.decay, **f32)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba2_ssd_fwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), s_fin.data_ptr(), states.data_ptr(),
            decay.data_ptr(), B, L, H, P, N, c, pl.group,
            _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "mamba2_ssd_fwd")
    mamba2_ssd_fwd.launches += 1
    return y, s_fin


mamba2_ssd_fwd.launches = 0


def mamba2_ssd_bwd(x, dt, A, Bm, Cm, dy):
    """The SSD scan backward, same contract as :func:`ssd_backward_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernels,
    or raise on what they do not take. ``mamba2_ssd_bwd.launches`` counts
    calls that launch."""
    if x.device.type == "cpu":
        return ssd_backward_plain(x, dt, A, Bm, Cm, dy)
    B, L, H, P, N, c = _check(x, dt, A, Bm, Cm, (dy,))
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    pl = plan(B, L, H, P, N, _sms(x.device))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((B, L, H), **f32)
    dA = torch.empty((H,), **f32)
    dBm = torch.empty((B, L, N), **f32)
    dCm = torch.empty((B, L, N), **f32)
    # scratch: carried states and state cotangents per chunk, the chunks'
    # decays, per-head-group partials of dBm and dCm and per-(head, chunk)
    # ones of dA
    states = torch.empty(pl.states, **f32)
    gstates = torch.empty(pl.states, **f32)
    decay = torch.empty(pl.decay, **f32)
    dB_part = torch.empty(pl.parts, **f32)
    dC_part = torch.empty(pl.parts, **f32)
    dA_part = torch.empty(pl.dA_part, **f32)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mamba2_ssd_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(), states.data_ptr(),
            gstates.data_ptr(), decay.data_ptr(), dB_part.data_ptr(),
            dC_part.data_ptr(), dA_part.data_ptr(), B, L, H, P, N, c,
            pl.group, _DTYPE_CODE[x.dtype], stream)
    _build.check(err, "mamba2_ssd_bwd")
    mamba2_ssd_bwd.launches += 1
    return dx, ddt, dA, dBm, dCm


mamba2_ssd_bwd.launches = 0
