"""Public kernel surface of the PyTorch port (the counterpart of
``repro.kernels.ops``): the paged decode attention (K1), the dense-cache
decode attention (K2), the paged KV append, :func:`flash_attention`,
the no-cache attention with its gradient (K3a forward, K3b backward),
:func:`mamba2_ssd`, the chunked SSD scan with its gradient (K4 forward,
K4b backward), :func:`rwkv6_wkv`, the chunked RWKV-6 WKV with its
gradient (K5 forward, K5b backward), and :func:`gmm`, the grouped matmul
of the MoE experts with its gradient (K6 forward, K6b backward), with
:func:`moe_gmm_apply` around it for tokens in any order; each launches
hand-written CUDA kernels on CUDA tensors and runs its plain PyTorch
version on CPU tensors.

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
with the host (boolean-mask filtering in PyTorch would). No serving path
launches it: the decode steps hand the new token to K1 or K2, whose launch
writes it too (``k_new``, ``v_new``, ``slots``); it stays the counterpart
of the reference's public op, for the callers that append alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention, decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain, quantise_kv, update_kv_buffer_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain,
)
from repro_torch.kernels.moe_gmm import (  # noqa: F401
    gmm_backward_plain, gmm_bwd, gmm_fwd, gmm_plain,
)
from repro_torch.kernels.mamba2_scan import (  # noqa: F401
    mamba2_ssd_bwd, mamba2_ssd_fwd, ssd_backward_plain, ssd_chunked_plain,
)
from repro_torch.kernels.rwkv6_scan import (  # noqa: F401
    rwkv6_wkv_bwd, rwkv6_wkv_fwd, wkv6_backward_plain, wkv6_chunked_plain,
)


@dataclasses.dataclass(frozen=True)
class Kernels:
    """What a model's forward runs in place of its kernels, for
    comparisons; each None takes the kernel's wrapper (its plain version
    on CPU tensors). A family reads the fields it has and ignores the
    rest: ``attend`` the layers' attention, in the signature of the
    forward's branch (:func:`flash_attention` without a cache, the
    encoder-decoder's encoder and cross-attention included, at Sq != Skv
    for the latter; :func:`paged_decode_attention` or
    :func:`decode_attention` with one, the encoder-decoder's decode-time
    cross-attention included: :func:`decode_attention` of the new row over
    the encoder's positions, with no new token), ``ssd`` the hybrid's scan
    (:func:`mamba2_ssd`), ``wkv`` rwkv6's WKV (:func:`rwkv6_wkv`) and
    ``gmm`` an MoE layer's grouped matmul (:func:`gmm`), ``append`` the
    decode branches' KV append (:func:`update_kv_buffer`). With neither
    ``attend`` nor ``append`` given, a decode branch makes one call that
    appends and attends (K1 or K2 with the new token's slots); with
    either, it appends and attends in two calls. ``dots_policy``
    is no kernel: the selective-checkpoint policy a transformer layer runs
    under ``remat="dots"`` (None: ``models.module.save_products``), so a
    control can take its place too."""
    attend: Callable | None = None
    ssd: Callable | None = None
    wkv: Callable | None = None
    gmm: Callable | None = None
    append: Callable | None = None
    dots_policy: Callable | None = None


KERNELS = Kernels()     # every kernel its own


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``repro.kernels.ops``): the forward
    keeps ``(q, k, v, o, lse)``, the backward runs K3b on them. For bf16
    inputs that need a gradient the kept ``o`` is the forward's float32
    output before its rounding, which K3b takes delta = rowsum(do * o)
    from (the reference takes it from the bf16 ``o``; see
    ``kernels.flash_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o32 = None
        if q.dtype != torch.float32 and any(ctx.needs_input_grad[:3]):
            o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, out_f32=o32)
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, lse)
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


class _Rwkv6Wkv(torch.autograd.Function):
    """The WKV with its gradient: the forward keeps only its inputs, the
    backward runs K5b on them (which recomputes the carried states). The
    final state is not differentiable: training never reads it, and K5b
    takes its cotangent as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        o, s_fin = rwkv6_wkv_fwd(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.mark_non_differentiable(s_fin)
        return o, s_fin

    @staticmethod
    def backward(ctx, do, _ds_fin):
        return rwkv6_wkv_bwd(*ctx.saved_tensors, do.contiguous())


def rwkv6_wkv(r, k, v, w, u):
    """The chunked RWKV-6 WKV of r, k, v [B,L,H,hd] with the decay w
    [B,L,H,hd] float32 and the bonus u [H,hd] float32 -> (o [B,L,H,hd] in
    r's dtype, s_final [B,H,hd,hd] float32), differentiable in o: K5
    forward and K5b backward on CUDA tensors, their plain versions on CPU
    tensors (see ``kernels.rwkv6_scan``)."""
    return _Rwkv6Wkv.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                           w.contiguous(), u.contiguous())


class _Gmm(torch.autograd.Function):
    """The grouped matmul with its gradient: the forward keeps its inputs,
    the backward runs K6b on them."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, tile_m):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.tile_m = tile_m
        return gmm_fwd(x, w, tile_expert, tile_m)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert = ctx.saved_tensors
        dx, dw = gmm_bwd(x, w, tile_expert, ctx.tile_m, dy.contiguous())
        return dx, dw, None, None


def gmm(x, w, tile_expert, tile_m: int):
    """x [T, K] in tiles of ``tile_m`` rows, tile t times ``w[tile_expert
    [t]]`` of w [E, K, N] -> [T, N] in x's dtype, differentiable in x and
    w: K6 forward and K6b backward on CUDA tensors, their plain versions
    on CPU tensors (see ``kernels.moe_gmm``). Without gradients (a decode
    step: 3 calls a layer) it calls K6 directly, past the autograd
    function's bookkeeping."""
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Gmm.apply(x, w, tile_expert, tile_m)
    return gmm_fwd(x, w, tile_expert, tile_m)


def moe_gmm_apply(x, w, expert_of_token, *, n_experts: int,
                  tile_m: int = 128, gmm_fn=None):
    """The ragged expert matmul with its sort/pad bookkeeping on the
    device (the reference's ``moe_gmm_apply``): x [T, D]; w [E, D, F];
    expert_of_token [T] int -> [T, F] in the input's token order.

    Tokens are sorted stably by expert, each group is padded to a multiple
    of ``tile_m`` rows in a buffer of ``Tp = (ceil(T / tile_m) + E)
    tile_m`` zero rows, every tile gets its expert's id (tiles past the
    last group the last expert's, as the reference clips them), and
    ``gmm_fn`` (default :func:`gmm`) multiplies the tiles. No step reads a
    count back to the host."""
    T, D = x.shape
    E = n_experts
    ids = expert_of_token.long()
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    group_sizes = torch.zeros(E, dtype=torch.long, device=x.device)
    group_sizes.scatter_add_(0, ids, torch.ones_like(ids))
    padded = (group_sizes + tile_m - 1) // tile_m * tile_m
    ends = torch.cumsum(padded, 0)
    Tp = (-(-T // tile_m) + E) * tile_m
    rank = torch.arange(T, device=x.device) - (
        torch.cumsum(group_sizes, 0) - group_sizes)[sorted_ids]
    slot = (ends - padded)[sorted_ids] + rank
    xp = x.new_zeros((Tp, D))
    xp[slot] = x[order]
    tile_start = torch.arange(0, Tp, tile_m, device=x.device)
    tile_ids = torch.searchsorted(ends, tile_start, right=True)
    tile_ids = tile_ids.clamp(0, E - 1).to(torch.int32)
    out_p = (gmm_fn or gmm)(xp, w, tile_ids, tile_m)
    out = torch.empty((T, out_p.shape[1]), dtype=out_p.dtype,
                      device=x.device)
    out[order] = out_p[slot]
    return out


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
