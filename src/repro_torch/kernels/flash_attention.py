"""Flash attention without a cache, forward (K3a) and backward (K3b): each
a wrapper around hand-written CUDA kernels beside its plain PyTorch
version.

* :func:`flash_attention_fwd` returns ``(o, lse)``; its kernels
  (``csrc/flash_attention.cu``: ``fa_fwd_mma`` for bf16, ``fa_fwd_f32``)
  replace the Pallas ``flash_attention_fwd`` / ``_fwd_kernel`` of
  ``src/repro/kernels/flash_attention.py``.
* :func:`flash_attention_bwd` returns ``(dq, dk, dv)`` from the forward's
  inputs, ``o``, ``lse`` and ``do``; its kernels (``fa_dq_*`` and
  ``fa_dkv_*``) replace the Pallas ``flash_attention_bwd`` /
  ``_dq_kernel``, ``_dkv_kernel``. ``delta = rowsum(do * o)`` is a
  PyTorch op before the launch, as the reference computes it outside its
  kernels.

Layout: the path's own, ``q, o, do [B,Sq,H,hd]`` and ``k, v [B,Skv,KV,hd]``
(the Pallas kernels take ``[B,H,S,hd]``), ``lse [B,H,Sq]`` float32; query
head ``h`` attends KV head ``h // (H // KV)``. Scores are scaled by
``hd ** -0.5`` unless ``scale`` is given. Causal attention keeps key ``j``
for query ``i`` when ``i >= j`` (the kernels take it with ``Sq == Skv``
only, where that is also the Pallas kernels' mask and ``attention_ref``'s).
Every query row and key is covered; the Pallas kernels leave rows from
``(Sq // 128) * 128`` on unwritten when S is not a multiple of the tile.

Bound on an H100: operations (see ``csrc/flash_attention.cu``), 2 * B * H *
S^2 * hd FLOPs for a causal forward, 5 * B * H * S^2 * hd for the backward,
at the bf16 or f32 peak.

Precision: the plain versions compute in float32 throughout, except that
the forward rounds the softmax weights to V's dtype before the PV product,
as ``flash_attention_xla`` does. The bf16 kernels accumulate in f32 on the
tensor cores and round their operands p and dS to bf16 (p relative to the
running max, not the final one); ``chip_smoke.py`` holds them to the plain
versions within a tolerance relative to the largest |output|.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 80, 128)


def _grouped(t, KV):
    """[B,S,H,hd] -> float32 [B,S,KV,G,hd]."""
    B, S, H, hd = t.shape
    return t.reshape(B, S, KV, H // KV, hd).float()


def _causal_keep(Sq, Skv, q_offset, device):
    """[Sq,Skv] bool: query ``i`` sees key ``j`` iff q_offset + i >= j."""
    qpos = q_offset + torch.arange(Sq, device=device)
    return qpos[:, None] >= torch.arange(Skv, device=device)[None, :]


def flash_attention_fwd_plain(q, k, v, *, causal, scale=None, q_offset=0):
    """q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] -> (o [B,Sq,H,hd] in q's dtype,
    lse [B,H,Sq] float32). Scores in float32 from the inputs, masked with
    -inf (causal: query ``q_offset + i`` sees keys ``j <= q_offset + i``),
    softmax weights rounded to V's dtype before the PV product, as in the
    JAX package's ``flash_attention_xla``; lse = max + log(sum) as the
    Pallas kernel gives it. The kernel takes ``q_offset = 0`` only."""
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
    return (o.reshape(B, Sq, H, hd).to(q.dtype).contiguous(),
            lse.reshape(B, H, Sq).contiguous())


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal, scale=None):
    """The Pallas backward's arithmetic in float32: p = exp(s * scale -
    lse) (0 where masked), delta = rowsum(do * o), dv = p^T do, dS = p *
    (do v^T - delta) * scale, dq = dS k, dk = dS^T q, dk and dv summed over
    the G query heads of each KV head. Returns (dq, dk, dv) in the inputs'
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


def flash_attention_fwd(q, k, v, *, causal, scale=None):
    """Flash attention forward, same contract as
    :func:`flash_attention_fwd_plain` (``q_offset = 0``). CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise on what it
    does not take. ``flash_attention_fwd.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    B, Sq, H, hd = _check(q, k, v, causal, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
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
    CUDA tensors launch the kernels (dq, then dk/dv, one call), or raise on
    what they do not take. ``flash_attention_bwd.launches`` counts
    calls."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale)
    B, Sq, H, hd = _check(q, k, v, causal, (q, k, v, o, lse, do))
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o and do must match q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} / "
                         f"{tuple(do.shape)} {do.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse [B,H,Sq] float32 expected, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, k.shape[2], Sq, k.shape[1], hd,
            hd ** -0.5 if scale is None else scale, int(causal),
            _DTYPE_CODE[q.dtype], stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _check(q, k, v, causal, tensors):
    """What the kernels take: q [B,Sq,H,hd], k and v [B,Skv,KV,hd] with H
    a multiple of KV and hd in ``HEAD_DIMS``, all float32 or all bfloat16,
    every input on q's device, contiguous and 16-byte aligned; causal only
    with Sq == Skv. Returns (B, Sq, H, hd)."""
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
    return B, Sq, H, hd
