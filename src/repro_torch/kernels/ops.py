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
version on CPU tensors. :func:`moe_dispatch` and :func:`moe_combine` are
the dropless experts' bookkeeping around K6 (no kernel of their own): the
(token, choice) rows sorted into a table of whole tiles an expert, and
back.

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
            o32 = torch.empty(q.shape[:3] + v.shape[3:], dtype=torch.float32,
                              device=q.device)
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
    """Attention of q [B,S,H,hd] over k [B,S,KV,hd], v [B,S,KV,hdv] ->
    [B,S,H,hdv], differentiable: K3a forward and K3b backward on CUDA
    tensors, their plain versions on CPU tensors (see
    ``kernels.flash_attention``)."""
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

    :func:`moe_dispatch` with one choice a token sorts the tokens stably
    by expert into a table of whole tiles of ``tile_m`` rows, ``gmm_fn``
    (default :func:`gmm`) multiplies the tiles, and each token's row is
    taken back. No step reads a count back to the host."""
    table, tile_expert, slot, _ = moe_dispatch(
        x, expert_of_token[:, None], n_experts=n_experts, tile_m=tile_m)
    return (gmm_fn or gmm)(table, w, tile_expert, tile_m).index_select(
        0, slot)


def dispatch_rows(assignments: int, n_experts: int, tile_m: int) -> int:
    """Rows of :func:`moe_dispatch`'s table: ``assignments + n_experts
    (tile_m - 1)`` rounded up to whole tiles, the most that groups padded
    to whole tiles can fill, so the table's size depends on no routing."""
    rows = assignments + n_experts * (tile_m - 1)
    return -(-rows // tile_m) * tile_m


class _MoeDispatch(torch.autograd.Function):
    """The table's rows gathered from the tokens (a zero row where
    ``row_token`` is the token count); the gradient of each token is the
    sum of its K rows' gradients in choice order (no atomics)."""

    @staticmethod
    def forward(ctx, x, slot, row_token):
        ctx.save_for_backward(slot)
        ctx.tokens = x.shape[0]
        return torch.cat([x, x.new_zeros((1, x.shape[1]))]).index_select(
            0, row_token)

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        return (g.index_select(0, slot).view(ctx.tokens, -1, g.shape[1])
                .sum(1), None, None)


class _MoeCombine(torch.autograd.Function):
    """out[t] = sum over j of gates[t, j] rows[slot[t K + j]], in float32
    (or the rows' wider dtype) over j in order, rounded once to the rows'
    dtype."""

    @staticmethod
    def forward(ctx, rows, slot, gates):
        ctx.save_for_backward(rows, slot, gates)
        T, K = gates.shape
        wide = torch.promote_types(rows.dtype, torch.float32)
        y = rows.index_select(0, slot).view(T, K, -1).to(wide)
        return (y * gates.to(wide)[..., None]).sum(1).to(rows.dtype)

    @staticmethod
    def backward(ctx, g):
        rows, slot, gates = ctx.saved_tensors
        T, K = gates.shape
        wide = torch.promote_types(rows.dtype, torch.float32)
        gw = g.to(wide)[:, None, :]
        y = rows.index_select(0, slot).view(T, K, -1).to(wide)
        dgates = (y * gw).sum(-1).to(gates.dtype)
        drows = torch.zeros_like(rows).index_copy_(
            0, slot, (gw * gates.to(wide)[..., None]).to(rows.dtype)
            .view(T * K, -1))
        return drows, None, dgates


def moe_dispatch(x, expert_idx, *, n_experts: int, tile_m: int = 128):
    """The dropless dispatch of ``x [T, D]`` to its tokens' experts
    ``expert_idx [T, K]``: each (token, choice) ``a = t K + j`` sorted
    stably by expert into a table of :func:`dispatch_rows` rows, each
    expert's rows padded to whole tiles of ``tile_m``, zero rows between.
    Returns ``(table [rows, D], tile_expert [rows / tile_m] int32, slot
    [T K] int64, routed [n_experts] int64)``: the table, differentiable in
    x; each tile's expert (``n_experts``, out of range, past the last
    group: K6 skips such a tile and gives zero rows); the table row of each
    (token, choice); and the rows each expert got. Everything stays on the
    device: no count is read back, and the table's size is the same in
    every call. ``moe_dispatch.launches`` counts calls."""
    T, D = x.shape
    K, E = expert_idx.shape[1], n_experts
    ids = expert_idx.reshape(-1).long()
    order = torch.argsort(ids, stable=True)
    routed = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, ids, torch.ones_like(ids))
    padded = (routed + tile_m - 1) // tile_m * tile_m
    ends = torch.cumsum(padded, 0)
    sorted_ids = ids[order]
    within = torch.arange(T * K, device=x.device) - (
        torch.cumsum(routed, 0) - routed)[sorted_ids]
    slot = torch.empty_like(ids)
    slot[order] = (ends - padded)[sorted_ids] + within
    rows = dispatch_rows(T * K, E, tile_m)
    row_token = torch.full((rows,), T, dtype=torch.long, device=x.device)
    row_token[slot] = torch.arange(T * K, device=x.device) // K
    tile_expert = torch.searchsorted(
        ends, torch.arange(0, rows, tile_m, device=x.device),
        right=True).to(torch.int32)
    moe_dispatch.launches += 1
    return (_MoeDispatch.apply(x, slot, row_token), tile_expert, slot,
            routed)


moe_dispatch.launches = 0


def moe_combine(rows, slot, gates):
    """The experts' output rows ``rows [R, D]`` of :func:`moe_dispatch`'s
    table back in token order, weighted: ``out [T, D]`` with ``out[t] =
    sum_j gates[t, j] rows[slot[t K + j]]`` (``gates [T, K]`` float32),
    summed in float32 over j in order and rounded once to the rows' dtype:
    two calls give the same bits. Differentiable in ``rows`` and
    ``gates``."""
    return _MoeCombine.apply(rows, slot, gates)


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
