"""Encoder-decoder transformer of the PyTorch port (seamless-m4t-medium;
the counterpart of ``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, S_enc, D]``. The encoder is a stack of
non-causal self-attention layers with rope; the decoder a causal
transformer whose every layer also cross-attends the encoder's output.
Training and prefill run both stacks without a cache; a decode step takes
the encoder's output (``enc_out``) and a carried dense KV cache of the
decoder's self-attention. The reference's ``lax.scan`` over stacked layers
is a Python loop over views of the stacked ``[L, ...]`` parameters here.

Kernels (``ops.Kernels.attend``; the plain versions replace them for
comparisons): without a cache, the encoder's, the decoder's and the
cross-attention all run ``ops.flash_attention`` (K3a/K3b); in a decode
step, the self-attention over the carried cache and the cross-attention
of the one new row over the S_enc encoder positions both run
``ops.decode_attention`` (K2), the self-attention's launch also writing
the new token's K/V (``ops.update_kv_buffer`` writes it only when a
comparison gives ``attend``). As in the reference, a decode step projects
the cross-attention's K/V from ``enc_out`` in every layer anew.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch import weights
from repro_torch.config import Family, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import (
    ParamBuilder, checkpoint_layer, layer_slice, stack_layers,
    unstack_layers,
)
from repro_torch.sharding import constrain
# the decoder's carried cache is the transformer's: {k,v: [n_layers, B,
# max_len, KV * kv_rep, hd]} in kv_cache_dtype, with its axes
from repro_torch.models.transformer import (  # noqa: F401
    _embed, _logits, cache_axes, init_cache,
)


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         master: bool = False) -> dict:
    """Random parameters from ``seed`` on ``device`` in the reference's
    tree: ``embed``; ``encoder`` stacked ``[n_enc_layers, ...]`` (``attn``,
    ``mlp``, ``ln_attn``, ``ln_mlp``); ``decoder`` stacked ``[n_layers,
    ...]`` (``self_attn``, ``cross_attn``, ``mlp``, ``ln_self``,
    ``ln_cross``, ``ln_mlp``); ``enc_norm``, ``final_norm`` and
    ``lm_head``. Each leaf is held in ``weights.held_dtype`` (``master``
    for training; ``meta``: shapes and dtypes only)."""
    return _build(cfg, seed, device, master).params


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the tree of :func:`init`."""
    return _build(cfg, 0, "meta", True).axes


def _build(cfg: ModelConfig, seed, device, master) -> ParamBuilder:
    if cfg.family != Family.ENCDEC:
        raise ValueError(f"the encoder-decoder takes the ENCDEC family, not "
                         f"{cfg.family}")
    dtype_of = partial(weights.held_dtype, cfg=cfg, master=master)
    pb = ParamBuilder(seed, dtype_of, device)
    pb.param("embed", (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
             scale=1.0)

    def enc_one(lpb: ParamBuilder, i: int):
        L.init_attention(lpb, cfg)
        L.init_mlp(lpb, cfg)
        lpb.param("ln_attn", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln_mlp", (cfg.d_model,), ("embed",), init="ones")

    def dec_one(lpb: ParamBuilder, i: int):
        L.init_attention(lpb, cfg, prefix="self_attn")
        L.init_attention(lpb, cfg, prefix="cross_attn")
        L.init_mlp(lpb, cfg)
        lpb.param("ln_self", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln_cross", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln_mlp", (cfg.d_model,), ("embed",), init="ones")

    pb.params["encoder"], pb.axes["encoder"] = stack_layers(
        seed, dtype_of, device, cfg.n_enc_layers, enc_one)
    # the decoder's layers draw from their own names
    pb.params["decoder"], pb.axes["decoder"] = stack_layers(
        seed + 7, dtype_of, device, cfg.n_layers, dec_one)
    pb.param("enc_norm", (cfg.d_model,), ("embed",), init="ones")
    pb.param("final_norm", (cfg.d_model,), ("embed",), init="ones")
    pb.param("lm_head", (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return pb


def _enc_layer(cfg, p, x, *, step, kernels, rules):
    a = L.attention(p["attn"], cfg, L.rmsnorm(x, p["ln_attn"]), step=step,
                    causal=False, attend=kernels.attend, rules=rules)
    x = x + a
    return x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln_mlp"]), rules)


def encode(params, cfg: ModelConfig, frames, *,
           kernels: ops.Kernels = ops.KERNELS, rules=None):
    """frames [B,S_enc,D] (precomputed modality embeddings, the stub) ->
    enc_out [B,S_enc,D] in compute dtype: non-causal self-attention with
    rope at positions 0..S_enc-1 via ``kernels.attend`` (default
    ``ops.flash_attention``), each layer checkpointed unless ``cfg.remat``
    is "none" ("dots" too, as in the reference), then ``enc_norm``.
    ``rules``: the reference's sharding constraints."""
    x = constrain(frames.to(weights.torch_dtype(cfg.compute_dtype)), rules,
                  "batch", "seq", "embed")
    B, S, _ = x.shape
    step = L.nocache_step(cfg, torch.arange(S, device=x.device).expand(B, S))
    layer = checkpoint_layer(cfg, partial(_enc_layer, cfg, step=step,
                                          kernels=kernels, rules=rules))
    for p in unstack_layers(params["encoder"], cfg.n_enc_layers):
        x = layer(p, x)
    return L.rmsnorm(x, params["enc_norm"])


def _dec_layer(cfg, p, x, enc_out, *, step, cross, kernels, rules,
               **cache):
    a = L.attention(p["self_attn"], cfg, L.rmsnorm(x, p["ln_self"]),
                    step=step, attend=kernels.attend, append=kernels.append,
                    rules=rules, **cache)
    x = x + a
    c = L.attention(p["cross_attn"], cfg, L.rmsnorm(x, p["ln_cross"]),
                    step=cross, kv_x=enc_out, causal=False,
                    attend=kernels.attend, rules=rules)
    x = x + c
    return x + L.mlp(p["mlp"], L.rmsnorm(x, p["ln_mlp"]), rules)


def decode_stack(params, cfg: ModelConfig, tokens, enc_out, *, cache=None,
                 cache_len=None, kernels: ops.Kernels = ops.KERNELS,
                 rules=None):
    """The decoder over ``tokens [B,S]`` against ``enc_out [B,S_enc,D]``.

    Without a cache: causal self-attention of the S tokens, then
    cross-attention over enc_out, then the MLP, each layer checkpointed as
    :func:`encode`'s. With ``cache`` ``{"k", "v": [L,B,S_max,KV,hd]}`` and
    ``cache_len [B]`` int32 (one token a row): the carried-cache
    self-attention of ``layers.attention`` (updated IN PLACE), then
    cross-attention of the one row over enc_out. Then ``final_norm`` and
    ``lm_head``. Returns ``(logits [B,S,V] float32, cache or None)``.
    ``rules``: the reference's sharding constraints and KV replication."""
    x = constrain(_embed(params, cfg, tokens), rules, "batch", "seq",
                  "embed")
    B, S, _ = x.shape
    enc_out = enc_out.to(x.dtype)
    decode = cache is not None
    cross = L.cross_step(enc_out, decode=decode)
    if not decode:
        step = L.nocache_step(cfg, torch.arange(S, device=x.device)
                              .expand(B, S))
        layer = checkpoint_layer(cfg, partial(
            _dec_layer, cfg, step=step, cross=cross, kernels=kernels,
            rules=rules))
        for p in unstack_layers(params["decoder"], cfg.n_layers):
            x = layer(p, x, enc_out)
        new_cache = None
    else:
        k, v = cache["k"], cache["v"]
        positions = cache_len[:, None] + torch.arange(
            S, dtype=cache_len.dtype, device=x.device)
        step = L.dense_step(cfg, positions, cache_len, k.shape[2])
        for i in range(cfg.n_layers):
            x = _dec_layer(cfg, layer_slice(params["decoder"], i), x,
                           enc_out, step=step, cross=cross, kernels=kernels,
                           rules=rules, carried_cache=(k, v, i))
        new_cache = {"k": k, "v": v}
    return _logits(params, cfg, x, rules), new_cache


def forward(params, cfg: ModelConfig, tokens, *, frames=None, embeds=None,
            cache=None, cache_len=None, enc_out=None,
            kernels: ops.Kernels = ops.KERNELS, rules=None):
    """Training and prefill: ``frames`` (or ``embeds``, the same) [B,S_enc,D]
    and ``tokens [B,S]`` -> ``(logits [B,S,V] float32, None)``, the encoder
    run first. Decode: ``enc_out`` [B,S_enc,D] (from :func:`encode`), a
    carried ``cache`` and ``cache_len``; one token a row appended ->
    ``(logits [B,1,V], cache)``. ``kernels``: see the module's docstring.

    Raises ValueError without frames and without enc_out (the reference
    fails there on ``None.astype``), and with a cache but no enc_out."""
    if enc_out is None:
        if cache is not None:
            raise ValueError("a decode step takes the encoder's output: "
                             "give enc_out with the cache")
        src = frames if frames is not None else embeds
        if src is None:
            raise ValueError("the encoder-decoder needs frames (or embeds) "
                             "or enc_out")
        enc_out = encode(params, cfg, src, kernels=kernels, rules=rules)
    return decode_stack(params, cfg, tokens, enc_out, cache=cache,
                        cache_len=cache_len, kernels=kernels, rules=rules)

