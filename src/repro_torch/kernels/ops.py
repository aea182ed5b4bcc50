"""Public kernel surface of the PyTorch port (the counterpart of
``repro.kernels.ops``): the paged decode attention (K1), the dense-cache
decode attention (K2), the paged KV append, :func:`flash_attention`,
the no-cache attention with its gradient (K3a forward, K3b backward), and
:func:`mamba2_ssd`, the chunked SSD scan with its gradient (K4 forward,
K4b backward); each launches hand-written CUDA kernels on CUDA tensors and
runs its plain PyTorch version on CPU tensors.

:func:`update_kv_buffer` replaces ``repro.kernels.ops.update_kv_buffer``
(a jnp scatter with ``mode="drop"``). Unlike the reference it updates the
arena in place: the arena is the largest tensor of the step after the
weights (L x NB x BS x KV x hd elements for k and as many for v, shared
by every sequence), and a functional
update would copy it on every layer of every step. Its kernel
(``kv_append`` in ``csrc/paged_decode.cu``) is bound by bytes: it reads
each row's new K/V once and writes it once, ``4 * B * KV * hd * itemsize``
bytes in all, in 16-byte units where the row and the pointers allow; the
out-of-range drop is a compare inside the kernel, so the call never syncs
with the host (boolean-mask filtering in PyTorch would).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain,
)
from repro_torch.kernels.mamba2_scan import (  # noqa: F401
    mamba2_ssd_bwd, mamba2_ssd_fwd, ssd_backward_plain, ssd_chunked_plain,
)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``repro.kernels.ops``): the forward
    keeps ``(q, k, v, o, lse)``, the backward runs K3b on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=True):
    """Attention of q [B,S,H,hd] over k, v [B,S,KV,hd] -> [B,S,H,hd],
    differentiable: K3a forward and K3b backward on CUDA tensors, their
    plain versions on CPU tensors (see ``kernels.flash_attention``)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal)


class _Mamba2Ssd(torch.autograd.Function):
    """The SSD scan with its gradient: the forward keeps only its inputs,
    the backward runs K4b on them (which recomputes the carried states).
    The final state is not differentiable: training never reads it, and
    K4b takes its cotangent as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        y, s_fin = mamba2_ssd_fwd(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.mark_non_differentiable(s_fin)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, _ds_fin):
        return mamba2_ssd_bwd(*ctx.saved_tensors, dy.contiguous())


def mamba2_ssd(x, dt, A, Bm, Cm):
    """The chunked SSD scan of x [B,L,H,P] with dt [B,L,H], A [H] and Bm,
    Cm [B,L,N] float32 -> (y [B,L,H,P] in x's dtype, s_final [B,H,N,P]
    float32), differentiable in y: K4 forward and K4b backward on CUDA
    tensors, their plain versions on CPU tensors (see
    ``kernels.mamba2_scan``)."""
    return _Mamba2Ssd.apply(x.contiguous(), dt.contiguous(), A.contiguous(),
                            Bm.contiguous(), Cm.contiguous())


def update_kv_buffer_plain(k_pages, v_pages, k_new, v_new, slots):
    """k_pages/v_pages [NB,BS,KV,hd]; k_new/v_new [B,KV,hd]; slots [B]
    flat slot indices (block_id * BS + offset). Writes each row at its slot
    in place and returns the pages; slots outside ``[0, NB*BS)`` are
    dropped (the reference's ``mode="drop"``; negative slots, which the
    reference would wrap, are dropped too and never occur on the path)."""
    NB, BS, KV, hd = k_pages.shape
    kf = k_pages.view(NB * BS, KV, hd)
    vf = v_pages.view(NB * BS, KV, hd)
    keep = (slots >= 0) & (slots < NB * BS)
    idx = slots[keep].long()
    kf[idx] = k_new[keep].to(kf.dtype)
    vf[idx] = v_new[keep].to(vf.dtype)
    return k_pages, v_pages


def update_kv_buffer(k_pages, v_pages, k_new, v_new, slots):
    """Paged KV append, same contract as :func:`update_kv_buffer_plain`.
    CPU tensors take the plain version; CUDA tensors launch the
    ``kv_append`` kernel, or raise on what it does not take.
    ``update_kv_buffer.launches`` counts kernel launches."""
    if k_pages.device.type == "cpu":
        return update_kv_buffer_plain(k_pages, v_pages, k_new, v_new, slots)
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages [NB,BS,KV,hd] expected, got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    NB, BS, KV, hd = k_pages.shape
    B = k_new.shape[0]
    if k_new.shape != (B, KV, hd) or v_new.shape != k_new.shape \
            or slots.shape != (B,):
        raise ValueError(f"k_new/v_new [B,KV,hd] and slots [B] expected, got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)} / "
                         f"{tuple(slots.shape)}")
    if not (k_new.dtype == v_new.dtype == v_pages.dtype == k_pages.dtype):
        raise TypeError(f"new rows must already be in the arena dtype "
                        f"{k_pages.dtype}, got {k_new.dtype}/{v_new.dtype}")
    if slots.dtype != torch.int32:
        raise TypeError(f"slots must be int32, got {slots.dtype}")
    tensors = (k_pages, v_pages, k_new, v_new, slots)
    if any(t.device != k_pages.device for t in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if B == 0:
        return k_pages, v_pages
    row_bytes = KV * hd * k_pages.element_size()
    lib = _build.library()
    with torch.cuda.device(k_pages.device):
        stream = torch.cuda.current_stream(k_pages.device).cuda_stream
        err = lib.kv_append_launch(
            k_pages.data_ptr(), v_pages.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), slots.data_ptr(), B, NB * BS, row_bytes, stream)
    _build.check(err, "update_kv_buffer")
    update_kv_buffer.launches += 1
    return k_pages, v_pages


update_kv_buffer.launches = 0
