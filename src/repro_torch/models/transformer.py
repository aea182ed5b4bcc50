"""Decoder-only transformer LM of the PyTorch port, dense or with MoE FFNs
(the counterpart of ``repro.models.transformer``): ``init``, ``forward``
without a cache (training and prefill, with the config's
rematerialisation) or as a decode step over a paged arena or a carried
dense cache, ``init_paged_arena``, ``init_cache``, and the logical axes
of the parameters (``param_axes``) and of the cache (``cache_axes``). The
reference's ``lax.scan`` over stacked layers is a Python loop over views
of the stacked ``[L, ...]`` parameters here.

A ``port_configs.MlaMoeConfig`` (the DeepSeek-V3 layout, which the JAX
package does not have) takes latent attention (``models.mla``), its
leading dense layers in a stack of their own, and ``moe_mlp_dropless``;
it trains and prefills without a cache only.
"""
from __future__ import annotations

import contextlib
from functools import partial

import torch

from repro_torch import port_configs, weights
from repro_torch.config import Family, ModelConfig
from repro_torch.core.genesys.trace import current_recorder
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.module import (
    ParamBuilder, layer_slice, remat, stack_layers, unstack_layers,
)
from repro_torch.sharding import constrain

# families whose decoder is this transformer (llava's backbone takes the
# same tokens-only decode, paged or dense; MoE swaps the MLP for moe_mlp)
DECODER_FAMILIES = (Family.DENSE, Family.VLM, Family.MOE)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         master: bool = False) -> dict:
    """Random parameters from ``seed`` on ``device``, each held in
    ``weights.held_dtype``: for serving, matrices in compute dtype and
    norms in params dtype; with ``master`` (training), all in params
    dtype. On ``device="meta"`` the tree has shapes and dtypes only."""
    return _build(cfg, seed, device, master).params


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the tree of :func:`init`
    (built on ``meta``: nothing is allocated)."""
    return _build(cfg, 0, "meta", True).axes


def _build(cfg: ModelConfig, seed, device, master) -> ParamBuilder:
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"the transformer takes the dense, VLM and MoE "
                         f"families, not {cfg.family}")
    dtype_of = partial(weights.held_dtype, cfg=cfg, master=master)
    pb = ParamBuilder(seed, dtype_of, device)
    pb.param("embed", (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
             scale=1.0)
    if port_configs.is_mla(cfg):
        _build_mla(pb, cfg, seed, dtype_of, device)
        return pb

    def one(lpb: ParamBuilder, i: int):
        L.init_attention(lpb, cfg)
        if cfg.family == Family.MOE:
            MOE.init_moe(lpb, cfg)
        else:
            L.init_mlp(lpb, cfg)
        lpb.param("ln_attn", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln_mlp", (cfg.d_model,), ("embed",), init="ones")
    pb.params["blocks"], pb.axes["blocks"] = stack_layers(
        seed, dtype_of, device, cfg.n_layers, one)
    pb.param("final_norm", (cfg.d_model,), ("embed",), init="ones")
    if not cfg.tie_embeddings:
        pb.param("lm_head", (cfg.d_model, cfg.padded_vocab),
                 ("embed", "vocab"))
    return pb


def _build_mla(pb, cfg, seed, dtype_of, device) -> None:
    """The DeepSeek-V3 layout: ``dense_blocks``, the leading
    ``first_k_dense`` layers (MLA and a dense SwiGLU), then ``blocks``,
    the MoE layers (MLA and ``moe.moe_mlp_dropless``)."""
    def norms(lpb):
        lpb.param("ln_attn", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln_mlp", (cfg.d_model,), ("embed",), init="ones")

    def dense(lpb: ParamBuilder, i: int):
        MLA.init_attention(lpb, cfg)
        MLA.init_dense_mlp(lpb, cfg)
        norms(lpb)

    def moe(lpb: ParamBuilder, i: int):
        MLA.init_attention(lpb, cfg)
        MOE.init_moe_dropless(lpb, cfg)
        norms(lpb)
    if cfg.first_k_dense:
        pb.params["dense_blocks"], pb.axes["dense_blocks"] = stack_layers(
            seed, dtype_of, device, cfg.first_k_dense, dense)
    pb.params["blocks"], pb.axes["blocks"] = stack_layers(
        seed, dtype_of, device, cfg.n_moe_layers, moe, cfg.first_k_dense)
    pb.param("final_norm", (cfg.d_model,), ("embed",), init="ones")
    if not cfg.tie_embeddings:
        pb.param("lm_head", (cfg.d_model, cfg.padded_vocab),
                 ("embed", "vocab"))


def _block(cfg, p, x, *, step, kernels, rules=None, **cache):
    h = L.attention(p["attn"], cfg, L.rmsnorm(x, p["ln_attn"]), step=step,
                    attend=kernels.attend, append=kernels.append,
                    rules=rules, **cache)
    x = x + h
    if cfg.family == Family.MOE:
        return x + MOE.moe_mlp(p, cfg, L.rmsnorm(x, p["ln_mlp"]),
                               gmm=kernels.gmm, rules=rules)
    return x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln_mlp"]), rules)


def _embed(params, cfg, tokens):
    """The token embeddings in compute dtype (gathered, then cast: the
    same values as the reference's cast-then-gather)."""
    return L.embed(params["embed"], tokens,
                   weights.torch_dtype(cfg.compute_dtype))


def _mla_block(cfg, p, x, layer, *, step, kernels, rules=None, rec=None):
    """A layer of the DeepSeek-V3 layout: MLA, then the dense SwiGLU
    (``layer`` None) or MoE layer ``layer``'s dropless experts. ``rec``,
    the forward's span recorder, is adopted where a recomputation runs on
    autograd's thread, so the MoE spans nest under ``backward`` there."""
    eps = cfg.rms_eps
    with rec.adopted() if rec is not None else contextlib.nullcontext():
        x = x + MLA.attention(p["attn"], cfg, L.rmsnorm(x, p["ln_attn"], eps),
                              step=step, attend=kernels.attend, rules=rules)
        h = L.rmsnorm(x, p["ln_mlp"], eps)
        if layer is None:
            return x + L.mlp(p["mlp"], h, rules)
        return x + MOE.moe_mlp_dropless(p, cfg, h, gmm=kernels.gmm,
                                        layer=layer)


def _logits(params, cfg, x, rules=None, eps=1e-6):
    x = L.rmsnorm(x, params["final_norm"], eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = constrain(L.proj(x, head), rules, "batch", "seq", "vocab")
    return logits.float()


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, positions=None,
            cache_len=None, paged_cache=None, cache=None,
            kernels: ops.Kernels = ops.KERNELS, rules=None):
    """The model over ``tokens [B,S]`` int. Without a cache, the training
    and prefill forward; with one of two caches, one decode step.

    No cache: ``embeds [B,P,D]`` (a VLM's precomputed prefix) goes before
    the tokens' embeddings; ``positions [B,P+S]`` default to 0, 1, ...;
    every layer attends causally over the whole sequence through
    ``kernels.attend`` (default: ``ops.flash_attention``, the K3a/K3b
    kernels on CUDA tensors) and runs under ``cfg.remat``
    (``module.remat``; "dots" keeps the weight products by
    ``kernels.dots_policy``, default ``module.save_products``). The
    layers are taken apart from their ``[L, ...]`` stacks once
    (``unstack_layers``). Returns ``(logits [B,P+S,V] float32, None)``.

    Decode: tokens [B,1]; cache_len [B] int32 (positions already cached
    per row).

    paged_cache ``(k_pages, v_pages, block_tables)``: arenas
    [L,NB,BS,KV,hd] shared by all rows and per-row block tables [B,MB]
    int32; every layer writes the new token's K/V into its slice of the
    arenas, then attends through the same block table.

    cache ``{"k": kc, "v": vc}``: the carried dense cache [L,B,S,KV,hd]
    (:func:`init_cache`); every layer attends its slice together with the
    new token, then writes the token at ``cache_len`` (dropped from S on).

    Either is updated IN PLACE (the reference returns new arrays) and
    returned. ``kernels.attend`` is the layers' attention (default: the
    CUDA kernel wrapper of the branch; the plain versions for
    comparisons). Returns ``(logits [B,1,V] float32, {"k": k, "v": v})``.

    ``kernels.gmm`` is an MoE layer's grouped matmul (default ``ops.gmm``,
    K6/K6b on CUDA tensors; ``kernels.moe_gmm.gmm_plain`` is the plain
    version). The other fields of ``kernels`` are other families'.

    ``rules`` (``sharding.ShardingRules``) adds the reference's sharding
    constraints and KV replication (``layers.attention``); a cache then
    holds ``KV * rules.kv_rep`` heads (``init_cache(..., kv_rep=)``)."""
    if paged_cache is not None and cache is not None:
        raise ValueError("give at most one of paged_cache and cache")
    if port_configs.is_mla(cfg) and (paged_cache is not None
                                     or cache is not None):
        raise ValueError(f"{cfg.arch_id}: latent attention (MLA) runs "
                         f"without a cache only; its decode (a latent "
                         f"paged cache) is not built")
    x = constrain(_embed(params, cfg, tokens), rules, "batch", "seq",
                  "embed")
    if paged_cache is None and cache is None:
        return _forward_nocache(params, cfg, x, embeds, positions,
                                kernels, rules), None
    S = x.shape[1]
    positions = cache_len[:, None] + torch.arange(
        S, dtype=cache_len.dtype, device=x.device)
    if paged_cache is not None:
        k, v, bt = paged_cache
        step = L.paged_step(cfg, positions, cache_len, bt, k.shape[2])
        layer_caches = [{"paged_cache": (k, v, bt, i)}
                        for i in range(cfg.n_layers)]
    else:
        k, v = cache["k"], cache["v"]
        step = L.dense_step(cfg, positions, cache_len, k.shape[2])
        layer_caches = [{"carried_cache": (k, v, i)}
                        for i in range(cfg.n_layers)]
    blocks = params["blocks"]
    for i, layer_cache in enumerate(layer_caches):
        x = _block(cfg, layer_slice(blocks, i), x, step=step,
                   kernels=kernels, rules=rules, **layer_cache)
    return _logits(params, cfg, x, rules), {"k": k, "v": v}


def _forward_nocache(params, cfg, x, embeds, positions, kernels, rules):
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if port_configs.is_mla(cfg):
        return _forward_mla(params, cfg, x, positions, kernels, rules)
    step = L.nocache_step(cfg, positions)
    block = remat(cfg, partial(_block, cfg, step=step, kernels=kernels,
                               rules=rules), kernels.dots_policy)
    for layer in unstack_layers(params["blocks"], cfg.n_layers):
        x = block(layer, x)
    return _logits(params, cfg, x, rules)


def _forward_mla(params, cfg, x, positions, kernels, rules):
    block = remat(cfg, partial(_mla_block, cfg,
                               step=MLA.nocache_step(cfg, positions),
                               kernels=kernels, rules=rules,
                               rec=current_recorder()),
                  kernels.dots_policy)
    if cfg.first_k_dense:
        for layer in unstack_layers(params["dense_blocks"],
                                    cfg.first_k_dense):
            x = block(layer, x, None)
    for i, layer in enumerate(unstack_layers(params["blocks"],
                                             cfg.n_moe_layers)):
        x = block(layer, x, i)
    return _logits(params, cfg, x, rules, cfg.rms_eps)


def init_paged_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device="cuda", kv_rep: int = 1) -> dict:
    """Block arenas for paged decode: {k,v: [L, NB, BS, KV * kv_rep, hd]}
    zeros in ``kv_cache_dtype``. One arena serves every concurrent
    sequence; block 0 is the pool's null block."""
    dtype = weights.torch_dtype(cfg.kv_cache_dtype)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads * kv_rep,
             cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", kv_rep: int = 1) -> dict:
    """The carried dense KV cache: {k,v: [L, batch, max_len, KV * kv_rep,
    hd]} zeros in ``kv_cache_dtype`` (``kv_rep``: the rules' KV
    replication)."""
    dtype = weights.torch_dtype(cfg.kv_cache_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads * kv_rep, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_cache`'s tree."""
    ax = ("stack", "batch", "seq", "kv_heads", "kv_head_dim")
    return {"k": ax, "v": ax}
