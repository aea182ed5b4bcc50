"""Dense decoder-only transformer LM of the PyTorch port (the counterpart of
``repro.models.transformer``): ``init``, ``forward`` without a cache
(training and prefill, with the config's rematerialisation) or as a decode
step over a paged arena or a carried dense cache, ``init_paged_arena`` and
``init_cache``. The reference's ``lax.scan`` over stacked layers is a
Python loop over views of the stacked ``[L, ...]`` parameters here.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import weights
from repro_torch.config import Family, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import (
    ParamBuilder, layer_slice, stack_layers, unstack_layers,
)

# families whose decoder is this dense transformer (llava's backbone takes
# the same tokens-only decode, paged or dense); MoE waits for its port
DECODER_FAMILIES = (Family.DENSE, Family.VLM)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         master: bool = False) -> dict:
    """Random parameters from ``seed`` on ``device``, each held in
    ``weights.held_dtype``: for serving, matrices in compute dtype and
    norms in params dtype; with ``master`` (training), all in params
    dtype."""
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"the port has the dense transformer only, not "
                         f"{cfg.family} (other model families are a later "
                         f"slice of the port)")
    dtype_of = partial(weights.held_dtype, cfg=cfg, master=master)
    pb = ParamBuilder(seed, dtype_of, device)
    pb.param("embed", (cfg.padded_vocab, cfg.d_model), scale=1.0)

    def one(lpb: ParamBuilder, i: int):
        L.init_attention(lpb, cfg)
        L.init_mlp(lpb, cfg)
        lpb.param("ln_attn", (cfg.d_model,), init="ones")
        lpb.param("ln_mlp", (cfg.d_model,), init="ones")
    pb.params["blocks"] = stack_layers(seed, dtype_of, device, cfg.n_layers,
                                       one)
    pb.param("final_norm", (cfg.d_model,), init="ones")
    if not cfg.tie_embeddings:
        pb.param("lm_head", (cfg.d_model, cfg.padded_vocab))
    return pb.params


def _block(cfg, p, x, *, step, attend, **cache):
    h = L.attention(p["attn"], cfg, L.rmsnorm(x, p["ln_attn"]), step=step,
                    attend=attend, **cache)
    x = x + h
    return x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln_mlp"]))


def _remat(fn, cfg):
    """``fn`` run as ``cfg.remat`` says (the reference's ``_remat``):
    "none" plainly, "full" under activation checkpointing (only the
    block's inputs are kept; the backward runs the block again). "dots"
    is not ported: no config uses it (ROADMAP.md, Queue 1 item 8)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        raise ValueError("remat='dots' is not ported yet: no config uses it "
                         "(ROADMAP.md, Queue 1 item 8)")
    raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")


def _embed(params, cfg, tokens):
    """The token embeddings in compute dtype (gathered, then cast: the
    same values as the reference's cast-then-gather)."""
    return params["embed"][tokens.long()].to(
        weights.torch_dtype(cfg.compute_dtype))


def _logits(params, cfg, x):
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).float()


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, positions=None,
            cache_len=None, paged_cache=None, cache=None, attend=None,
            ssd=None):
    """The model over ``tokens [B,S]`` int. Without a cache, the training
    and prefill forward; with one of two caches, one decode step.

    No cache: ``embeds [B,P,D]`` (a VLM's precomputed prefix) goes before
    the tokens' embeddings; ``positions [B,P+S]`` default to 0, 1, ...;
    every layer attends causally over the whole sequence through
    ``attend`` (default: ``ops.flash_attention``, the K3a/K3b kernels on
    CUDA tensors) and runs under ``cfg.remat``. The layers are taken apart
    from their ``[L, ...]`` stacks once (``unstack_layers``). Returns
    ``(logits [B,P+S,V] float32, None)``.

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
    returned. ``attend`` is the layers' attention (default: the CUDA
    kernel wrapper of the branch; the plain versions for comparisons).
    Returns ``(logits [B,1,V] float32, {"k": k, "v": v})``.

    ``ssd`` is the hybrid's scan (``models.mamba2.forward``), taken so the
    families share one signature; a transformer has no scan and ignores
    it."""
    if paged_cache is not None and cache is not None:
        raise ValueError("give at most one of paged_cache and cache")
    x = _embed(params, cfg, tokens)
    if paged_cache is None and cache is None:
        return _forward_nocache(params, cfg, x, embeds, positions,
                                attend), None
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
        x = _block(cfg, layer_slice(blocks, i), x, step=step, attend=attend,
                   **layer_cache)
    return _logits(params, cfg, x), {"k": k, "v": v}


def _forward_nocache(params, cfg, x, embeds, positions, attend):
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    step = L.nocache_step(cfg, positions)
    block = _remat(partial(_block, cfg, step=step, attend=attend), cfg)
    for layer in unstack_layers(params["blocks"], cfg.n_layers):
        x = block(layer, x)
    return _logits(params, cfg, x)


def init_paged_arena(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device="cuda") -> dict:
    """Block arenas for paged decode: {k,v: [L, NB, BS, KV, hd]} zeros in
    ``kv_cache_dtype``. One arena serves every concurrent sequence; block 0
    is the pool's null block."""
    dtype = weights.torch_dtype(cfg.kv_cache_dtype)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """The carried dense KV cache: {k,v: [L, batch, max_len, KV, hd]}
    zeros in ``kv_cache_dtype``."""
    dtype = weights.torch_dtype(cfg.kv_cache_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
