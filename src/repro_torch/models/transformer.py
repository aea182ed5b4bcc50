"""Dense decoder-only transformer LM of the PyTorch port (the counterpart of
``repro.models.transformer``): ``init``, the decode ``forward`` over a
paged arena or a carried dense cache, ``init_paged_arena`` and
``init_cache``. The reference's ``lax.scan`` over stacked layers is a
Python loop over views of the stacked ``[L, ...]`` parameters here.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch import weights
from repro_torch.config import Family, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import ParamBuilder, layer_slice, stack_layers

# families whose decoder is this dense transformer (llava's backbone takes
# the same tokens-only decode, paged or dense); MoE waits for its port
DECODER_FAMILIES = (Family.DENSE, Family.VLM)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device``, each held in
    ``weights.held_dtype`` (matrices in compute dtype, norms in params
    dtype)."""
    if cfg.family not in DECODER_FAMILIES:
        raise ValueError(f"the port has the dense transformer only, not "
                         f"{cfg.family} (other model families are a later "
                         f"slice of the port)")
    dtype_of = partial(weights.held_dtype, cfg=cfg)
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


def forward(params, cfg: ModelConfig, tokens, *, cache_len,
            paged_cache=None, cache=None, attend=None):
    """One decode step, over exactly one of two caches. tokens [B,1] int;
    cache_len [B] int32 (positions already cached per row).

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
    Returns ``(logits [B,1,V] float32, {"k": k, "v": v})``."""
    if (paged_cache is None) == (cache is None):
        raise ValueError("give exactly one of paged_cache and cache")
    dt = weights.torch_dtype(cfg.compute_dtype)
    x = params["embed"].to(dt)[tokens.long()]
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
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(dt)
    return logits.float(), {"k": k, "v": v}


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
