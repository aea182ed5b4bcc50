"""Flash attention without a cache, forward (K3a) and backward (K3b): each
a wrapper around hand-written CUDA kernels beside its plain PyTorch
version.

* :func:`flash_attention_fwd` returns ``(o, lse)``; its kernels
  (``csrc/flash_attention.cu``: ``fa_fwd_wgmma`` for bf16, ``fa_fwd_tf32``)
  replace the Pallas ``flash_attention_fwd`` / ``_fwd_kernel`` of
  ``src/repro/kernels/flash_attention.py``. For bf16 inputs it can also
  write ``out_f32``, the output before its rounding to bf16.
* :func:`flash_attention_bwd` returns ``(dq, dk, dv)`` from the forward's
  inputs, ``o``, ``lse`` and ``do``; its kernels replace the Pallas
  ``flash_attention_bwd`` / ``_dq_kernel``, ``_dkv_kernel`` and (bf16) the
  delta = rowsum(do * o) the reference computes before them. ``o`` may be
  that float32 output: the reference takes delta from ``o`` rounded to
  bf16, which moves delta by 2^-9 of ``|o| |do|``, and ``dS = p (dP -
  delta)`` cancels against delta, so where the keys are alike (a
  cross-attention over an encoder output that varies little) dq and dk
  come out wrong at full size; the differentiable ``ops.flash_attention``
  therefore keeps the float32 output for its backward. In bf16 it is
  three launches (:func:`bwd_launch`): ``fa_delta`` (delta from one
  read of ``o`` and ``do``), ``fa_dq_wgmma`` (a CTA per 128 query rows
  and head) and ``fa_dkv_wgmma`` (a CTA per 128 keys and *query* head, so
  the G heads of a KV head run in parallel), then with G > 1
  ``fa_dkv_reduce``, which sums the G heads' f32 partials in a fixed
  order. No atomics: two calls on the same inputs give the same bits. f32
  takes ``fa_dq_tf32`` and ``fa_dkv_tf32`` (a CTA per 64 keys and query
  head; ``fa_dkv_reduce`` sums the G heads' partials as in bf16), with
  delta summed in PyTorch as the plain version sums it.

Head dims: 32 (the reduced configs), 64, 80 and 128 (every full-width
config's), each on the kernels above, in both dtypes; in bf16 at hd 32 a
row is two 16-column slabs and a CTA one consumer warpgroup of 64 rows,
two CTAs an SM (see ``csrc/flash_attention.cu``).

Layout: the path's own, ``q, o, do [B,Sq,H,hd]`` and ``k, v [B,Skv,KV,hd]``
(the Pallas kernels take ``[B,H,S,hd]``), ``lse [B,H,Sq]`` float32; query
head ``h`` attends KV head ``h // (H // KV)``. Scores are scaled by
``hd ** -0.5`` unless ``scale`` is given. Causal attention keeps key ``j``
for query ``i`` when ``i >= j`` (the kernels take it with ``Sq == Skv``
only, where that is also the Pallas kernels' mask and ``attention_ref``'s).
Every query row and key is covered; the Pallas kernels leave rows from
``(Sq // 128) * 128`` on unwritten when S is not a multiple of the tile.

Bound on an H100: operations, 2 * B * H * S^2 * hd FLOPs for a causal
forward, 5 * B * H * S^2 * hd for the backward, at the bf16 peak, or in
f32 at the TF32 peak three times over (split TF32, below);
at hd 32 the exponentials (B * H * S^2 / 2 causal forward, twice that
backward) at the special-function units' rate take longer. The bf16
kernels put every product on ``wgmma`` with operands brought by TMA
through rings of shared-memory stages (warp specialised: one producer
warpgroup, two consumer warpgroups of 64 rows each, one at hd 32). The
TMA tensor maps are encoded for each call from the shapes
(:func:`tma_strides` checks what TMA takes); at hd 80 a row is a
64-column and a 16-column slab, at hd 32 two 16-column slabs, each slab
width with its own map and swizzle (see ``csrc/flash_attention.cu``).
The f32 kernels run their products on the tensor cores too, as split
TF32 on ``mma.sync`` (each operand a tf32 hi part and the tf32 rest,
three products: about 22 of f32's 24 bits): warps of 16 rows (4 a CTA, 8
in the backward at hd 128), the streamed operand through a 2-stage ring
of ``cp.async`` copies into rows of hd + 4 floats (in the backward split
once a CTA), p and dS kept in registers, each tile's products over keys
or rows summed fresh and added to the f32 sums. Where p >= 1/32, dq's dP
is summed again on the CUDA cores in the plain version's order: there
dS = p (dP - delta) cancels, and dq is the rounding of dP.

Precision: the plain versions compute in float32 throughout, except that
the forward rounds the softmax weights to V's dtype before the PV product,
as ``flash_attention_xla`` does. The bf16 kernels accumulate in f32 on the
tensor cores and round p (relative to the running max in the forward, not
the final one) and dS to bf16 once each for the products that take them;
the f32 kernels' products keep about 22 bits each
(``tests/test_torch_fa_tf32.py`` emulates them on the CPU). ``chip_smoke.py``
holds them to the plain versions within a tolerance relative to each
output vector's size.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
STATS_ROWS = 128       # bf16 kernels' query tile: stats rows pad to it
BWD_PARTS = 1 | 2 | 4  # the backward's launches: delta, dq, dk/dv


def _grouped(t, KV):
    """[B,S,H,hd] -> float32 [B,S,KV,G,hd]."""
    B, S, H, hd = t.shape
    return t.reshape(B, S, KV, H // KV, hd).float()


def _causal_keep(Sq, Skv, q_offset, device):
    """[Sq,Skv] bool: query ``i`` sees key ``j`` iff q_offset + i >= j."""
    qpos = q_offset + torch.arange(Sq, device=device)
    return qpos[:, None] >= torch.arange(Skv, device=device)[None, :]


def flash_attention_fwd_plain(q, k, v, *, causal, scale=None, q_offset=0,
                              out_f32=None):
    """q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] -> (o [B,Sq,H,hd] in q's dtype,
    lse [B,H,Sq] float32). Scores in float32 from the inputs, masked with
    -inf (causal: query ``q_offset + i`` sees keys ``j <= q_offset + i``),
    softmax weights rounded to V's dtype before the PV product, as in the
    JAX package's ``flash_attention_xla``; lse = max + log(sum) as the
    Pallas kernel gives it. ``out_f32``, a float32 tensor of q's shape if
    given, receives o before its cast to q's dtype. The kernel takes
    ``q_offset = 0`` only."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqkgh,bskh->bkgqs", _grouped(q, KV), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(Sq, Skv, q_offset, q.device),
                          float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1).clamp_min(1e-30)                # [B,KV,G,Sq]
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())
    o = o / denom.permute(0, 3, 1, 2)[..., None]
    lse = m[..., 0] + torch.log(denom)
    o = o.reshape(B, Sq, H, hd)
    if out_f32 is not None:
        out_f32.copy_(o)
    return o.to(q.dtype).contiguous(), lse.reshape(B, H, Sq).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal, scale=None):
    """The Pallas backward's arithmetic in float32: p = exp(s * scale -
    lse) (0 where masked), delta = rowsum(do * o), dv = p^T do, dS = p *
    (do v^T - delta) * scale, dq = dS k, dk = dS^T q, dk and dv summed over
    the G query heads of each KV head. ``o`` is in q's dtype or, the
    forward's ``out_f32``, float32. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    scale = hd ** -0.5 if scale is None else scale
    qf, dof = _grouped(q, KV), _grouped(do, KV)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse.reshape(B, KV, H // KV, Sq)[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(Sq, Skv, 0, q.device), 0.0)
    delta = (dof * _grouped(o, KV)).sum(dim=-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).reshape(B, Sq, H, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd(q, k, v, *, causal, scale=None, out_f32=None):
    """Flash attention forward, same contract as
    :func:`flash_attention_fwd_plain` (``q_offset = 0``; ``out_f32`` for
    bf16 inputs only, contiguous on q's device). CPU tensors take the
    plain version; CUDA tensors launch the kernel, or raise on what it
    does not take. ``flash_attention_fwd.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                         out_f32=out_f32)
    B, Sq, H, hd = _check(q, k, v, causal, (q, k, v))
    if out_f32 is not None and (
            q.dtype != torch.bfloat16 or out_f32.shape != q.shape
            or out_f32.dtype != torch.float32 or out_f32.device != q.device
            or not out_f32.is_contiguous()):
        raise ValueError(f"out_f32 must be a contiguous float32 "
                         f"{tuple(q.shape)} on {q.device}, for bf16 inputs")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if out_f32 is None else out_f32.data_ptr(),
            lse.data_ptr(), B, H, k.shape[2], Sq, k.shape[1], hd,
            hd ** -0.5 if scale is None else scale, int(causal),
            _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal, scale=None):
    """Flash attention backward, same contract as
    :func:`flash_attention_bwd_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernels (:func:`bwd_launch`: delta, dq, then
    dk/dv, one call), or raise on what they do not take.
    ``flash_attention_bwd.launches`` counts calls."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    _check_bwd(q, k, v, o, lse, do, causal)
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    bwd_launch(q, k, v, o, lse, do, grads, *bwd_scratch(q, k), causal=causal,
               scale=scale)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


def stats_pitch(Sq, dtype):
    """Row length of the backward's stats scratch (lse * log2 e and delta,
    ``[2, B, H, pitch]`` float32): the bf16 kernels read whole tiles of
    ``STATS_ROWS`` query rows, so their rows are padded to a multiple of it
    (a padded row has lse = +inf and delta = 0: its p is 0); the f32
    kernels index rows of ``Sq``."""
    if dtype == torch.float32:
        return Sq
    return -(-Sq // STATS_ROWS) * STATS_ROWS


def bwd_scratch(q, k):
    """The backward's float32 scratch on q's device: ``stats [2, B, H,
    stats_pitch]`` and, with G = H // KV > 1, ``partial [2, B, Skv, H,
    hd]`` (each query head's dk and dv before the sum over its KV head's G
    heads), else an empty tensor."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kw = {"dtype": torch.float32, "device": q.device}
    stats = torch.empty((2, B, H, stats_pitch(Sq, q.dtype)), **kw)
    partial = torch.empty((2, B, Skv, H, hd) if H != KV else (0,), **kw)
    return stats, partial


def bwd_launch(q, k, v, o, lse, do, grads, stats, partial, *, causal,
               scale=None, parts=BWD_PARTS):
    """Launch the backward's kernels on checked CUDA inputs, writing
    ``grads = (dq, dk, dv)`` (``torch.empty_like`` of q, k, v) with the
    scratch of :func:`bwd_scratch`. ``parts`` selects the launches (1 delta,
    2 dq, 4 dk/dv), so that each can be timed alone; dq and dk/dv read the
    stats that the delta launch wrote. Counts nothing."""
    B, Sq, H, hd = q.shape
    dq, dk, dv = grads
    if q.dtype == torch.float32 and parts & 1:
        # the f32 kernels take delta summed as the plain version sums it:
        # dS = p (dP - delta) cancels where dP ~ delta, and another order
        # of the same f32 sum moved dq past phase 6's f32 rule (2**-13)
        stats[1].copy_((do * o).sum(dim=-1).transpose(1, 2))
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
            partial.data_ptr() if partial.numel() else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, k.shape[2], Sq, k.shape[1],
            hd, stats.shape[-1], hd ** -0.5 if scale is None else scale,
            int(causal), _DTYPE_CODE[q.dtype], parts,
            int(o.dtype != q.dtype), stream)
    _build.check(err, "flash_attention_bwd")


def tma_strides(shape, itemsize):
    """Byte strides of the 4-D TMA tensor map the bf16 kernels put over a
    contiguous ``[B, S, N, hd]`` tensor (dims hd, N, S, B): a head, a row,
    a batch row. TMA takes only multiples of 16 bytes: raise on others
    before any launch."""
    B, S, N, hd = shape
    strides = (hd * itemsize, N * hd * itemsize, S * N * hd * itemsize)
    if any(st % 16 for st in strides):
        raise ValueError(f"a TMA tensor map over {tuple(shape)} with "
                         f"{itemsize}-byte elements needs strides that are "
                         f"multiples of 16 bytes, got {strides}")
    return strides


def _check_bwd(q, k, v, o, lse, do, causal):
    B, Sq, H, hd = _check(q, k, v, causal, (q, k, v, o, lse, do))
    if o.shape != q.shape or do.shape != q.shape \
            or o.dtype not in (q.dtype, torch.float32) \
            or do.dtype != q.dtype:
        raise ValueError(f"o (q's dtype or float32) and do must match q "
                         f"{tuple(q.shape)} {q.dtype}, got {tuple(o.shape)} "
                         f"{o.dtype} / {tuple(do.shape)} {do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse [B,H,Sq] float32 expected, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def _check(q, k, v, causal, tensors):
    """What the kernels take: q [B,Sq,H,hd], k and v [B,Skv,KV,hd] with H
    a multiple of KV and hd in ``HEAD_DIMS``, all float32 or all bfloat16,
    every input on q's device, contiguous and 16-byte aligned (bf16: with
    :func:`tma_strides`); causal only with Sq == Skv.
    Returns (B, Sq, H, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B,Sq,H,hd] and k, v [B,Skv,KV,hd] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if Bk != B or hdk != hd or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {hd}")
    if causal and Sq != Skv:
        raise ValueError(f"causal attention needs Sq == Skv, got {Sq} and "
                         f"{Skv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("all inputs must be contiguous and 16-byte aligned")
    if q.dtype == torch.bfloat16:
        tma_strides(q.shape, q.element_size())
        tma_strides(k.shape, k.element_size())
    return B, Sq, H, hd
