"""Shared model layers of the PyTorch port (the counterpart of
``repro.models.layers``): RMSNorm, RoPE, the SwiGLU and GELU MLPs, and
three branches of GQA attention: the no-cache one (training and prefill)
and two decode branches, the paged one and the carried dense-cache one.
Parameters come from
``models.module.ParamBuilder`` subtrees; one device, so the reference's
sharding constraints and Megatron KV replication (``kv_rep``) are gone.
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

__all__ = ["QSCALE", "rmsnorm", "rope_tables", "apply_rope", "rope",
           "flash_attention_xla", "paged_attention_xla",
           "decode_attention_xla", "decode_attention_two_part",
           "AttentionStep", "nocache_step", "paged_step", "dense_step",
           "init_attention", "attention", "init_mlp", "mlp", "proj"]


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
    ``flash_attention_xla``): q [B,Sq,H,hd]; k, v [B,Skv,KV,hd] (grouped)
    -> [B,Sq,H,hd]. Scores in float32, masked causally at
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


def init_attention(pb, cfg):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    a = pb.sub("attn")
    a.param("wq", (D, H, hd))
    a.param("wk", (D, KV, hd))
    a.param("wv", (D, KV, hd))
    a.param("wo", (H, hd, D))
    if cfg.qkv_bias:
        a.param("bq", (H, hd), init="zeros")
        a.param("bk", (KV, hd), init="zeros")
        a.param("bv", (KV, hd), init="zeros")


def proj(x, w):
    """x [B,S,D] @ w [D,*out] -> [B,S,*out] (einsum "bsd,d...->bs...")."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.to(x.dtype).reshape(D, -1)).view(
        B, S, *w.shape[1:])


@dataclass(frozen=True)
class AttentionStep:
    """What every layer's attention shares within one step: the rotary
    tables of the tokens' positions and, when decoding, each row's flat
    slot for its new K/V and the lengths to attend over. The reference
    computes these inside every layer and XLA folds the repeats; eager
    PyTorch would launch them once per layer, so the port computes them
    once per step (:func:`nocache_step`, :func:`paged_step`,
    :func:`dense_step`)."""
    cos: torch.Tensor     # [B,S,1,hd/2] float32
    sin: torch.Tensor
    # [B] int32. paged: block_tables[b, cl // BS] * BS + cl % BS in the
    # arena; dense: b * S + cl in a layer's [B*S] cache, B * S (dropped)
    # where cl >= S; None without a cache
    slots: torch.Tensor | None = None
    # [B] int32. paged: cache_len + 1 (the token is written first);
    # dense: cache_len (the token is attended apart); None without a cache
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
                         (cache_len + 1).to(torch.int32))


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


def _quantise(t, dtype):
    """The new K or V as the cache stores it: int8 by
    ``clip(round(t * QSCALE))``, else a cast."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(t * QSCALE), -127, 127).to(torch.int8)
    return t.to(dtype)


def attention(p, cfg, x, *, step: AttentionStep, paged_cache=None,
              carried_cache=None, attend=None):
    """GQA attention: the no-cache, paged or carried branch of the
    reference's ``attention``. x [B,S,D]; returns [B,S,D].

    No cache (training and prefill), ``step`` from :func:`nocache_step`
    over the S positions of each row: causal attention of the S tokens
    among themselves via ``attend(q, k, v, causal=True)`` (default: the
    differentiable ``ops.flash_attention``, K3a/K3b on CUDA tensors;
    :func:`flash_attention_xla` is the plain version).

    The two decode branches take ONE new token per row (S = 1).

    paged_cache ``(k_pages, v_pages, block_tables, layer)``, arenas
    [L,NB,BS,KV,hd] and block_tables [B,MB] int32, ``step`` from
    :func:`paged_step`: writes the token's K/V at its slot with
    ``ops.update_kv_buffer`` (in place: the layer's arena slice is a
    view), then attends through the block table over ``step.lens``
    positions via ``attend`` (default: the CUDA kernel wrapper
    ``ops.paged_decode_attention``). Inactive rows carry all-null block
    tables and cache_len 0: their writes land in the null block and their
    outputs are never read.

    carried_cache ``(kc, vc, layer)``, caches [L,B,S,KV,hd], ``step`` from
    :func:`dense_step`: attends the layer's cache below ``step.lens``
    together with the token itself, unquantised, via ``attend`` (default:
    the CUDA kernel wrapper ``ops.decode_attention``), then writes the
    token's K/V (int8: quantised) at ``[layer, b, cache_len[b]]`` in
    place, dropping rows at ``cache_len >= S``."""
    B, S, _ = x.shape
    if S != 1 and (paged_cache is not None or carried_cache is not None):
        raise ValueError(f"decode takes one token per row, got S={S}")
    q = proj(x, p["wq"])
    k = proj(x, p["wk"])
    v = proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = apply_rope(q, step.cos, step.sin)
    k = apply_rope(k, step.cos, step.sin)
    wo = p["wo"].reshape(-1, p["wo"].shape[-1])
    if paged_cache is None and carried_cache is None:
        out = (attend or ops.flash_attention)(q, k, v, causal=True)
        return proj(out.reshape(B, S, -1), wo)

    q1, k1, v1 = (t[:, 0].contiguous() for t in (q, k, v))
    if paged_cache is not None:
        kp, vp, bt, li = paged_cache
        kp_l, vp_l = kp[li], vp[li]
        ops.update_kv_buffer(kp_l, vp_l, _quantise(k1, kp.dtype),
                             _quantise(v1, vp.dtype), step.slots)
        out = (attend or ops.paged_decode_attention)(q1, kp_l, vp_l, bt,
                                                     step.lens)
    else:
        kc, vc, li = carried_cache
        kc_l, vc_l = kc[li], vc[li]     # [B,S,KV,hd] views
        out = (attend or ops.decode_attention)(q1, kc_l, vc_l, step.lens,
                                               k1, v1)
        # the write follows the read on the stream: nothing it overwrites
        # is read this step
        ops.update_kv_buffer(kc_l, vc_l, _quantise(k1, kc.dtype),
                             _quantise(v1, vc.dtype), step.slots)
    return proj(out.reshape(B, 1, -1), wo)


# ------------------------------------------------------------------ mlp -----

def init_mlp(pb, cfg):
    D, F_ = cfg.d_model, cfg.d_ff
    m = pb.sub("mlp")
    if cfg.mlp_kind == "swiglu":
        m.param("wi_gate", (D, F_))
    m.param("wi_up", (D, F_))
    m.param("wo", (F_, D))


def mlp(p, x):
    u = proj(x, p["wi_up"])
    if "wi_gate" in p:   # swiglu
        h = F.silu(proj(x, p["wi_gate"])) * u
    else:                # gelu 2-matrix (starcoder2 / seamless); jax.nn.gelu
        h = F.gelu(u, approximate="tanh")   # defaults to the tanh form
    return proj(h, p["wo"])
