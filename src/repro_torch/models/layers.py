"""Shared model layers of the PyTorch port (the counterpart of
``repro.models.layers``): RMSNorm, RoPE, the SwiGLU and GELU MLPs, and
the branches of GQA attention: the no-cache one (training and prefill;
causal, non-causal, or cross-attention over another source), two decode
branches, the paged one and the carried dense-cache one, and decode-time
cross-attention. Parameters come from
``models.module.ParamBuilder`` subtrees, each with the reference's logical
axes. ``rules`` (a ``sharding.ShardingRules``, default None) adds the
reference's sharding constraints (``sharding.constrain``: a no-op without
a mesh of more than one device) and its Megatron KV replication
(``rules.kv_rep``: each K/V head repeated to the tensor-parallel degree,
the cache holding ``KV * kv_rep`` heads).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (
    QSCALE, decode_attention_plain, paged_decode_attention_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_fwd_plain
from repro_torch.sharding import constrain

__all__ = ["QSCALE", "rmsnorm", "rope_tables", "apply_rope", "rope",
           "flash_attention_xla", "paged_attention_xla",
           "decode_attention_xla", "decode_attention_two_part",
           "AttentionStep", "nocache_step", "paged_step", "dense_step",
           "cross_step", "init_attention", "attention", "init_mlp", "mlp",
           "proj", "embed", "mergeable", "pinned", "placed_for"]


# ----------------------------------------------------------------- norms ----

def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


# ----------------------------------------------------------------- rope -----

def rope_tables(positions, hd: int, theta: float):
    """cos and sin [..., S, 1, hd/2] float32 of the reference's rotary
    angles ``positions * exp(-log(theta) * arange(hd/2) / (hd/2))``."""
    half = hd // 2
    log_theta = torch.full((), theta, dtype=torch.float32,
                           device=positions.device).log()
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs            # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cos, sin):
    """Rotate x [..., S, H, hd] by :func:`rope_tables`; a bf16 ``x`` is
    rotated in float32 and cast back, as in the reference."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] int (the reference's
    ``rope``)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------- no-cache attention ----

def flash_attention_xla(q, k, v, *, causal, q_offset=0):
    """The plain no-cache attention (the reference's
    ``flash_attention_xla``): q [B,Sq,H,hd]; k [B,Skv,KV,hd], v
    [B,Skv,KV,hdv] (grouped; hdv = hd but in latent attention) ->
    [B,Sq,H,hdv]. Scores in float32, masked causally at
    ``q_offset + i >= j``, softmax weights cast to V's dtype before the PV
    product; differentiable by autograd. The reference's online softmax
    over KV chunks gives the same function; this takes the softmax whole.
    The kernels behind ``ops.flash_attention`` must match it."""
    return flash_attention_fwd_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)[0]


# ------------------------------------------------------- paged attention ----

def paged_attention_xla(q, k_pages, v_pages, block_tables, lens):
    """The plain paged decode (the reference's ``paged_attention_xla``):
    q [B,1,H,hd]; k_pages/v_pages [NB,BS,KV,hd]; block_tables [B,MB];
    lens [B] -> [B,1,H,hd]. Gathers the pages and runs the masked softmax;
    the CUDA kernel behind ``ops.paged_decode_attention`` must match it."""
    return paged_decode_attention_plain(q[:, 0], k_pages, v_pages,
                                        block_tables, lens)[:, None]


# ------------------------------------------------------- dense attention ----

def decode_attention_xla(q, k_cache, v_cache, cache_len):
    """The plain dense decode (the reference's ``decode_attention_xla``):
    q [B,1,H,hd]; caches [B,S,KV,hd]; cache_len [B] -> [B,1,H,hd]."""
    return decode_attention_plain(q[:, 0], k_cache, v_cache,
                                  cache_len)[:, None]


def decode_attention_two_part(q, k_cache, v_cache, k_new, v_new, cache_len):
    """Decode without writing the cache first (the reference's
    ``decode_attention_two_part``): softmax over [cache masked below
    cache_len; new token]. q [B,1,H,hd]; caches [B,S,KV,hd]; k_new/v_new
    [B,1,KV,hd] -> [B,1,H,hd]. The CUDA kernel behind
    ``ops.decode_attention`` must match it."""
    return decode_attention_plain(q[:, 0], k_cache, v_cache, cache_len,
                                  k_new[:, 0], v_new[:, 0])[:, None]


def init_attention(pb, cfg, prefix: str = "attn"):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    a = pb.sub(prefix)
    a.param("wq", (D, H, hd), ("embed", "heads", "head_dim"))
    a.param("wk", (D, KV, hd), ("embed", "kv_heads", "kv_head_dim"))
    a.param("wv", (D, KV, hd), ("embed", "kv_heads", "kv_head_dim"))
    a.param("wo", (H, hd, D), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias:
        a.param("bq", (H, hd), ("heads", "head_dim"), init="zeros")
        a.param("bk", (KV, hd), ("kv_heads", "kv_head_dim"), init="zeros")
        a.param("bv", (KV, hd), ("kv_heads", "kv_head_dim"), init="zeros")


def mergeable(t, first: int, last: int = -1):
    """``t`` ready for its dims ``first`` to ``last`` (the last dim by
    default) to be merged into one.
    A plain tensor is returned as it is. A DTensor sharded on one of
    those dims after the first is gathered on it first: the merged dim
    keeps the sharding of its first part only (DTensor would otherwise
    need a strided shard, which its redistribution plans slowly or, in
    some versions, not at all)."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    last = last % t.dim()
    keep = [Replicate() if isinstance(p, Shard) and first < p.dim <= last
            else p for p in t.placements]
    if keep == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, keep)


def pinned(t):
    """``t``, taking its gradient back in its own placements (a plain
    tensor is returned as it is). After an op whose backward splits a dim
    that the forward merged: placement propagation may bring the gradient
    sharded on that dim, into parts DTensor cannot split."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def placed_for(x, w):
    """The weight ``w [K, N]`` of ``x [M, K] @ w``, placed as tensor and
    data parallelism place it (a plain ``w`` is returned as it is). On a
    mesh dim that splits x's rows (the batch), every device needs all of
    ``w``: it is gathered there (FSDP's weight gather). On one that splits
    x's K, ``w``'s K is split alike (row parallel: partial sums). Elsewhere
    ``w`` keeps its placement (column parallel on N). DTensor would
    otherwise choose, and may gather the activations instead."""
    if type(w) is torch.Tensor:
        return w
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    xp = (x.placements if isinstance(x, DTensor)
          else [Replicate()] * w.device_mesh.ndim)
    want = [Replicate() if px == Shard(0) else Shard(0) if px == Shard(1)
            else pw for px, pw in zip(xp, w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def proj(x, w):
    """x [B,S,D] @ w [D,*out] -> [B,S,*out] (einsum "bsd,d...->bs...")."""
    B, S, D = x.shape
    x2 = mergeable(x, 0, 1).reshape(B * S, D)
    w2 = placed_for(x2, mergeable(w, 1).to(x.dtype).reshape(D, -1))
    return (x2 @ w2).view(B, S, *w.shape[1:])


def embed(table, tokens, dtype):
    """The rows of ``table [V, D]`` at ``tokens`` (int), cast to ``dtype``
    (the same values as the reference's cast-then-gather). A DTensor table
    is gathered on the mesh dims that split the tokens and looked up by
    ``F.embedding``, which DTensor runs on a split vocabulary as partial
    sums; where a gradient is taken, it is gathered whole instead (DTensor
    cannot take such partial sums' gradient back)."""
    if type(table) is torch.Tensor:
        return table[tokens.long()].to(dtype)
    if torch.is_grad_enabled() and table.requires_grad:
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    else:
        table = placed_for(tokens, table)
    return F.embedding(tokens.long(), table).to(dtype)


@dataclass(frozen=True)
class AttentionStep:
    """What every layer's attention shares within one step: the rotary
    tables of the tokens' positions and, when decoding, each row's flat
    slot for its new K/V and the lengths to attend over. The reference
    computes these inside every layer and XLA folds the repeats; eager
    PyTorch would launch them once per layer, so the port computes them
    once per step (:func:`nocache_step`, :func:`paged_step`,
    :func:`dense_step`, and :func:`cross_step` for cross-attention, which
    has no rotary tables)."""
    cos: torch.Tensor | None     # [B,S,1,hd/2] float32
    sin: torch.Tensor | None
    # [B] int32. paged: block_tables[b, cl // BS] * BS + cl % BS in the
    # arena; dense: b * S + cl in a layer's [B*S] cache, B * S (dropped)
    # where cl >= S; None without a cache
    slots: torch.Tensor | None = None
    # [B] int32. paged and dense: cache_len, the positions cached before
    # the step's token (which is attended beside them); decode-time
    # cross-attention: the source's length; None without a cache
    lens: torch.Tensor | None = None


def nocache_step(cfg, positions) -> AttentionStep:
    """positions [B,S] int: the rotary tables of a training or prefill
    forward."""
    return AttentionStep(*rope_tables(positions, cfg.hd, cfg.rope_theta))


def paged_step(cfg, positions, cache_len, block_tables,
               block_size: int) -> AttentionStep:
    """positions [B,1]; cache_len [B] int32 (positions already cached per
    row); block_tables [B,MB] int32."""
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    B, MB = block_tables.shape
    rows = torch.arange(B, device=cache_len.device)
    # the reference's gather clamps the block index; clamp it the same way
    blk = torch.clamp(cache_len // block_size, 0, MB - 1).long()
    slots = block_tables[rows, blk] * block_size + cache_len % block_size
    return AttentionStep(cos, sin, slots.to(torch.int32),
                         cache_len.to(torch.int32))


def dense_step(cfg, positions, cache_len, max_len: int) -> AttentionStep:
    """positions [B,1]; cache_len [B] int32 (positions already cached per
    row) of a carried cache [L,B,max_len,KV,hd]. A row at
    ``cache_len >= max_len`` gets the out-of-range slot B * max_len, whose
    write is dropped (the reference's ``mode="drop"``); b * max_len +
    max_len would be row b+1's first position."""
    cos, sin = rope_tables(positions, cfg.hd, cfg.rope_theta)
    B = cache_len.shape[0]
    rows = torch.arange(B, device=cache_len.device)
    slots = torch.where(cache_len < max_len, rows * max_len + cache_len,
                        B * max_len)
    return AttentionStep(cos, sin, slots.to(torch.int32),
                         cache_len.to(torch.int32))


def cross_step(kv_x, *, decode: bool) -> AttentionStep:
    """kv_x [B,S_src,D]: the step of cross-attention over it. Without
    rotary tables (the reference applies no rope to cross-attention); when
    decoding, every row attends all S_src positions (``lens``)."""
    if not decode:
        return AttentionStep(None, None)
    B, S_src, _ = kv_x.shape
    return AttentionStep(None, None, lens=torch.full(
        (B,), S_src, dtype=torch.int32, device=kv_x.device))


def attention(p, cfg, x, *, step: AttentionStep, kv_x=None, causal=True,
              paged_cache=None, carried_cache=None, attend=None, append=None,
              rules=None):
    """GQA attention: the no-cache, paged or carried branch of the
    reference's ``attention``, or cross-attention. x [B,S,D]; returns
    [B,S,D].

    No cache (training and prefill), ``step`` from :func:`nocache_step`
    over the S positions of each row: attention of the S tokens among
    themselves, causal unless ``causal=False`` (an encoder's), via
    ``attend(q, k, v, causal=causal)`` (default: the differentiable
    ``ops.flash_attention``, K3a/K3b on CUDA tensors;
    :func:`flash_attention_xla` is the plain version).

    ``kv_x`` [B,S_src,D], ``step`` from :func:`cross_step`:
    cross-attention, K and V projected from ``kv_x``, neither q nor k
    rotated, never causal. Without a cache (``step.lens`` None) it is the
    no-cache branch at Sq = S and Skv = S_src; when decoding (S = 1,
    ``step.lens`` the source's length) one query row a request attends
    the S_src positions via ``attend(q [B,H,hd], k, v [B,S_src,KV,hd],
    lens)`` with no new token (default: the CUDA kernel wrapper
    ``ops.decode_attention``, K2; ``ops.decode_attention_plain`` is the
    plain version), the same signature as the carried branch's.

    The two decode branches take ONE new token per row (S = 1).

    paged_cache ``(k_pages, v_pages, block_tables, layer)``, arenas
    [L,NB,BS,KV,hd] and block_tables [B,MB] int32, ``step`` from
    :func:`paged_step`: writes the token's K/V at its slot (in place: the
    layer's arena slice is a view), then attends through the block table
    over the ``step.lens`` cached positions and the token. By default one
    call does both: ``ops.paged_decode_attention`` with the token and its
    slots (K1 on CUDA tensors). Given ``append`` or ``attend``, two calls:
    ``append`` (default ``ops.update_kv_buffer``), then ``attend``
    (default ``ops.paged_decode_attention``) over ``step.lens + 1``
    positions. Inactive rows carry all-null block tables and cache_len 0:
    their writes land in the null block and their outputs are never read.

    carried_cache ``(kc, vc, layer)``, caches [L,B,S,KV,hd], ``step`` from
    :func:`dense_step`: attends the layer's cache below ``step.lens``
    together with the token itself, unquantised, then writes the token's
    K/V (int8: quantised) at ``[layer, b, cache_len[b]]`` in place,
    dropping rows at ``cache_len >= S``. By default one call does both:
    ``ops.decode_attention`` with the token's slots (K2 on CUDA tensors);
    given ``append`` or ``attend``, ``attend`` (default
    ``ops.decode_attention``) then ``append`` (default
    ``ops.update_kv_buffer``).

    ``rules``: the reference's sharding constraints on q, k, v, the
    attention's output and the result, and, where ``rules.kv_rep > 1``,
    each K/V head repeated ``kv_rep`` times after the projection (the
    caches then hold ``KV * kv_rep`` heads)."""
    B, S, _ = x.shape
    if kv_x is not None and (paged_cache is not None
                             or carried_cache is not None):
        raise ValueError("cross-attention takes no cache")
    decode = (paged_cache is not None or carried_cache is not None
              or (kv_x is not None and step.lens is not None))
    if S != 1 and decode:
        raise ValueError(f"decode takes one token per row, got S={S}")
    kv_src = x if kv_x is None else kv_x
    q = proj(x, p["wq"])
    k = proj(kv_src, p["wk"])
    v = proj(kv_src, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if rules is not None and rules.kv_rep > 1:
        # Megatron-style KV replication to the TP degree: consecutive
        # copies keep the (KV_eff, G_eff) grouping of the attention
        k = k.repeat_interleave(rules.kv_rep, dim=2)
        v = v.repeat_interleave(rules.kv_rep, dim=2)
    q = constrain(q, rules, "batch", "seq", "heads", "head_dim")
    k = constrain(k, rules, "batch", "seq", "kv_heads", "kv_head_dim")
    v = constrain(v, rules, "batch", "seq", "kv_heads", "kv_head_dim")
    if kv_x is None:
        q = apply_rope(q, step.cos, step.sin)
        k = apply_rope(k, step.cos, step.sin)

    def output(out):        # out [B,S,H,hd] -> [B,S,D]
        out = constrain(out, rules, "batch", "seq", "heads", "head_dim")
        wo = mergeable(p["wo"], 0, 1).reshape(-1, p["wo"].shape[-1])
        y = proj(mergeable(out, 2).reshape(B, S, -1), wo)
        return constrain(y, rules, "batch", "seq", "embed")

    if not decode:
        return output((attend or ops.flash_attention)(
            q, k, v, causal=causal and kv_x is None))
    if kv_x is not None:
        out = (attend or ops.decode_attention)(q[:, 0].contiguous(), k, v,
                                               step.lens)
        return output(out.reshape(B, 1, *q.shape[2:]))

    q1, k1, v1 = (t[:, 0].contiguous() for t in (q, k, v))
    fused = attend is None and append is None
    if paged_cache is not None:
        kp, vp, bt, li = paged_cache
        kp_l, vp_l = kp[li], vp[li]
        if fused:
            out = ops.paged_decode_attention(q1, kp_l, vp_l, bt, step.lens,
                                             k1, v1, step.slots)
        else:
            (append or ops.update_kv_buffer)(
                kp_l, vp_l, ops.quantise_kv(k1, kp.dtype),
                ops.quantise_kv(v1, vp.dtype), step.slots)
            out = (attend or ops.paged_decode_attention)(
                q1, kp_l, vp_l, bt, step.lens + 1)
    else:
        kc, vc, li = carried_cache
        kc_l, vc_l = kc[li], vc[li]     # [B,S,KV,hd] views
        if fused:
            out = ops.decode_attention(q1, kc_l, vc_l, step.lens, k1, v1,
                                       step.slots)
        else:
            out = (attend or ops.decode_attention)(q1, kc_l, vc_l,
                                                   step.lens, k1, v1)
            # the write follows the read on the stream: nothing it
            # overwrites is read this step
            (append or ops.update_kv_buffer)(
                kc_l, vc_l, ops.quantise_kv(k1, kc.dtype),
                ops.quantise_kv(v1, vc.dtype), step.slots)
    return output(out.reshape(B, 1, *q.shape[2:]))


# ------------------------------------------------------------------ mlp -----

def init_mlp(pb, cfg, prefix: str = "mlp"):
    D, F_ = cfg.d_model, cfg.d_ff
    m = pb.sub(prefix)
    if cfg.mlp_kind == "swiglu":
        m.param("wi_gate", (D, F_), ("embed", "mlp"))
    m.param("wi_up", (D, F_), ("embed", "mlp"))
    m.param("wo", (F_, D), ("mlp", "embed"))


def mlp(p, x, rules=None):
    u = proj(x, p["wi_up"])
    if "wi_gate" in p:   # swiglu
        h = F.silu(proj(x, p["wi_gate"])) * u
    else:                # gelu 2-matrix (starcoder2 / seamless); jax.nn.gelu
        h = F.gelu(u, approximate="tanh")   # defaults to the tanh form
    h = constrain(h, rules, "batch", "seq", "mlp")
    return constrain(proj(h, p["wo"]), rules, "batch", "seq", "embed")
