"""Mamba2 (SSD) blocks and the zamba2 hybrid of the PyTorch port (the
counterpart of ``repro.models.mamba2``): a stack of mamba2 blocks and one
*shared* GQA attention + MLP block applied after every
``shared_attn_period`` of them, with the same weights each time.

Training and prefill run the chunked SSD scan (``kernels.ops.mamba2_ssd``:
K4 forward and K4b backward on CUDA tensors); decoding runs the O(1)-state
recurrence :func:`ssd_decode_step` in plain torch, as the reference does
outside any Pallas kernel. The reference's ``lax.scan`` over groups and
layers is a Python loop over the stacked ``[L, ...]`` parameters here.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch import weights
from repro_torch.config import Family, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import (
    ParamBuilder, layer_slice, stack_layers, unstack_layers,
)


# ---------------------------------------------------------------- decode ----

def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """One-token recurrence. x [b,h,p], dt [b,h], Bm/Cm [b,n] float32,
    state [b,h,n,p] float32 -> (y [b,h,p] in x's dtype, state')."""
    dA = torch.exp(dt * A)                                     # [b,h]
    upd = torch.einsum("bn,bh,bhp->bhnp", Bm, dt, x.float())
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    return y.to(x.dtype), state


# ----------------------------------------------------------- mamba block ----

def init_mamba_block(pb: ParamBuilder, cfg: ModelConfig) -> None:
    D, Din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    m = pb.sub("mamba")
    m.param("in_proj", (D, 2 * Din + 2 * N + nh))
    m.param("conv_w", (cfg.ssm_conv, Din + 2 * N), scale=0.5)
    m.param("A_log", (nh,), init="zeros")
    m.param("D", (nh,), init="ones")
    m.param("dt_bias", (nh,), init="zeros")
    m.param("norm", (Din,), init="ones")
    m.param("out_proj", (Din, D))
    pb.param("ln", (D,), init="ones")


def mamba_block(p, cfg: ModelConfig, x, *, ssm_state=None, conv_state=None,
                decode: bool = False, ssd=None):
    """x [B,L,D] (L = 1 in decode). Returns ``(y, (ssm_state',
    conv_state'))``.

    Chunked (``decode=False``): the depthwise causal conv over (x, B, C)
    from zero history, then the SSD scan through ``ssd(x, dt, A, Bm, Cm)
    -> (y, s_final)`` (default ``ops.mamba2_ssd``, K4/K4b on CUDA tensors;
    ``kernels.mamba2_scan.ssd_chunked_plain`` is the plain version). The
    scan starts from a zero state: no path of the port carries one into a
    chunked call, so ``ssm_state`` must be None.

    Decode: one token against ``conv_state [B,k-1,Din+2N]`` and
    ``ssm_state [B,h,n,p]`` float32 through :func:`ssd_decode_step`."""
    dt_ = x.dtype
    Din, N, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    m = p["mamba"]
    h = L.rmsnorm(x, p["ln"])
    z, xbc, dt = torch.split(L.proj(h, m["in_proj"]), [Din, Din + 2 * N, nh],
                             dim=-1)

    # depthwise causal conv over (x, B, C): the reference's sum of shifted
    # products (F.conv1d would run an f32 conv in TF32 under cuDNN)
    k = cfg.ssm_conv
    w = m["conv_w"].to(dt_)                                    # [k, Din+2N]
    if decode:
        hist = torch.cat([conv_state.to(dt_), xbc], dim=1)     # [B,k,Din+2N]
        conv = (hist * w[None]).sum(dim=1, keepdim=True)
        new_conv_state = hist[:, 1:]
    else:
        if ssm_state is not None:
            raise ValueError("the chunked scan starts from a zero state")
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
        hist = torch.cat([pad, xbc], dim=1)
        Lx = xbc.shape[1]
        conv = sum(hist[:, i:i + Lx] * w[i] for i in range(k))
        new_conv_state = hist[:, -(k - 1):]
    conv = F.silu(conv)

    xs, Bm, Cm = torch.split(conv, [Din, N, N], dim=-1)
    xs = xs.reshape(*xs.shape[:-1], nh, hp)
    dt = F.softplus(dt.float() + m["dt_bias"].float())
    A = -torch.exp(m["A_log"].float())

    if decode:
        y, new_state = ssd_decode_step(xs[:, 0], dt[:, 0], A,
                                       Bm[:, 0].float(), Cm[:, 0].float(),
                                       ssm_state)
        y = y[:, None]
    else:
        y, new_state = (ssd or ops.mamba2_ssd)(xs, dt, A, Bm.float(),
                                               Cm.float())
    y = y + xs * m["D"].to(dt_)[:, None]
    y = y.reshape(*y.shape[:-2], Din)
    # gated rmsnorm, then the out projection
    y = L.rmsnorm(y * F.silu(z), m["norm"])
    return x + L.proj(y, m["out_proj"]), (new_state, new_conv_state)


# ---------------------------------------------------------- zamba2 hybrid ---

def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         master: bool = False) -> dict:
    """zamba2: ``n_layers`` mamba blocks stacked ``[L, ...]`` under
    ``blocks``, and one ``shared`` attention + MLP block. Random from
    ``seed`` on ``device``, each parameter held in ``weights.held_dtype``
    (``master``: all in params dtype, for training)."""
    if cfg.family != Family.HYBRID:
        raise ValueError(f"mamba2.init builds the hybrid family, not "
                         f"{cfg.family}")
    dtype_of = partial(weights.held_dtype, cfg=cfg, master=master)
    pb = ParamBuilder(seed, dtype_of, device)
    pb.param("embed", (cfg.padded_vocab, cfg.d_model), scale=1.0)
    pb.params["blocks"] = stack_layers(
        seed, dtype_of, device, cfg.n_layers,
        lambda lpb, i: init_mamba_block(lpb, cfg))
    if cfg.shared_attn_period:
        sh = pb.sub("shared")
        L.init_attention(sh, cfg)
        L.init_mlp(sh, cfg)
        sh.param("ln_attn", (cfg.d_model,), init="ones")
        sh.param("ln_mlp", (cfg.d_model,), init="ones")
    pb.param("final_norm", (cfg.d_model,), init="ones")
    pb.param("lm_head", (cfg.d_model, cfg.padded_vocab))
    return pb.params


def _shared_attn(sp, cfg, x, *, step, attend, carried_cache=None):
    h = L.attention(sp["attn"], cfg, L.rmsnorm(x, sp["ln_attn"]), step=step,
                    attend=attend, carried_cache=carried_cache)
    x = x + h
    return x + L.mlp(sp["mlp"], L.rmsnorm(x, sp["ln_mlp"]))


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_period if cfg.shared_attn_period \
        else 0


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(groups, mamba layers per group): the shared block runs after each
    group."""
    period = cfg.shared_attn_period or cfg.n_layers
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {period}")
    return cfg.n_layers // period, period


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, positions=None,
            cache_len=None, cache=None, attend=None, ssd=None):
    """The hybrid over ``tokens [B,S]`` int: without a cache, the training
    and prefill forward; with one, one decode step.

    No cache: ``positions [B,S]`` default to 0, 1, ...; the mamba layers run
    the chunked scan through ``ssd`` (:func:`mamba_block`), each under
    activation checkpointing unless ``cfg.remat`` is "none" (the
    reference's ``jax.checkpoint(inner)``, for "full" and "dots" alike;
    the shared block is not checkpointed), and the shared block attends
    causally through ``attend`` (default ``ops.flash_attention``).
    Returns ``(logits [B,S,V] float32, None)``.

    Decode: tokens [B,1], cache_len [B] int32 and ``cache``
    (:func:`init_cache`): ``kv {k,v: [R,B,S,KV,hd]}`` of the R shared-block
    applications, ``ssm [L,B,h,n,p]`` float32 and ``conv
    [L,B,k-1,Din+2N]``. Application ``g`` of the shared block attends
    ``kv[g]`` through the carried dense-cache branch (``attend`` default
    ``ops.decode_attention``). Every leaf is updated IN PLACE (the
    reference returns new arrays) and the cache returned. Returns
    ``(logits [B,1,V] float32, cache)``.

    ``embeds`` is a VLM's patch prefix (``models.transformer.forward``),
    taken so the families share one signature; the hybrid has none and
    refuses one."""
    if embeds is not None:
        raise ValueError(f"{cfg.arch_id} takes no embeds prefix")
    x = params["embed"][tokens.long()].to(
        weights.torch_dtype(cfg.compute_dtype))
    B, S, _ = x.shape
    n_groups, period = _groups(cfg)
    decode = cache is not None
    if decode:
        positions = cache_len[:, None] + torch.arange(
            S, dtype=cache_len.dtype, device=x.device)
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
        step = L.dense_step(cfg, positions, cache_len, kc.shape[2])
    else:
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        step = L.nocache_step(cfg, positions)
        layer_fn = _remat(cfg, lambda lp, h: mamba_block(lp, cfg, h,
                                                         ssd=ssd)[0])
        layers = unstack_layers(params["blocks"], cfg.n_layers)

    for g in range(n_groups):
        for li in range(g * period, (g + 1) * period):
            if decode:
                x, (s2, c2) = mamba_block(
                    layer_slice(params["blocks"], li), cfg, x,
                    ssm_state=cache["ssm"][li], conv_state=cache["conv"][li],
                    decode=True)
                cache["ssm"][li].copy_(s2)
                cache["conv"][li].copy_(c2)
            else:
                x = layer_fn(layers[li], x)
        if cfg.shared_attn_period:
            x = _shared_attn(params["shared"], cfg, x, step=step,
                             attend=attend,
                             carried_cache=(kc, vc, g) if decode else None)

    x = L.rmsnorm(x, params["final_norm"])
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return logits, cache


def _remat(cfg, fn):
    """``fn`` under activation checkpointing unless ``cfg.remat`` is
    "none" (the reference checkpoints the mamba layers for any other
    mode)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none, full or dots, got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none":
        return fn
    return partial(ckpt.checkpoint, fn, use_reentrant=False)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeros: ``kv {k,v: [R,batch,max_len,KV,hd]}`` and ``conv
    [L,batch,k-1,Din+2N]`` in ``kv_cache_dtype``, ``ssm
    [L,batch,h,n,p]`` float32."""
    dtype = weights.torch_dtype(cfg.kv_cache_dtype)
    kv_shape = (n_shared_applications(cfg), batch, max_len, cfg.n_kv_heads,
                cfg.hd)
    return {
        "kv": {"k": torch.zeros(kv_shape, dtype=dtype, device=device),
               "v": torch.zeros(kv_shape, dtype=dtype, device=device)},
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }
