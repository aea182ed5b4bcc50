"""Step builders of the PyTorch port (the counterpart of
``repro.train.steps``): the paged serve step and the dense-cache serve
step. The train and prefill steps come with later slices."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer


def make_serve_step(cfg: ModelConfig, attend=None):
    """One decode step over the carried dense cache: ``(params, cache
    {k,v: [L,B,S,KV,hd]}, token [B,1], cache_len [B]) -> (next_token [B]
    int32, cache)``.

    ``attend(q [B,H,hd], k, v [B,S,KV,hd], lens, k_new, v_new)`` is the
    dense attention: ``None`` takes the CUDA kernel wrapper
    ``kernels.ops.decode_attention`` (its plain version on CPU tensors);
    ``kernels.ops.decode_attention_plain`` forces the plain version, for
    comparisons. The cache is updated in place and returned. Dense
    decoder-only models only."""
    if cfg.family not in transformer.DECODER_FAMILIES:
        raise ValueError(
            f"dense-cache decode in the port supports the dense "
            f"transformer, not {cfg.family} (the encoder-decoder is the "
            f"other-families slice of the port, with MoE, SSM and hybrid)")

    @torch.no_grad()
    def serve_step(params, cache, token, cache_len):
        logits, new_cache = transformer.forward(
            params, cfg, token, cache_len=cache_len, cache=cache,
            attend=attend)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_paged_serve_step(cfg: ModelConfig, attend=None):
    """One paged decode step over the genesys.pagedkv arena:
    ``(params, arenas {k,v: [L,NB,BS,KV,hd]}, block_tables [B,MB],
    token [B,1], cache_len [B]) -> (next_token [B] int32, arenas)``.

    ``attend(q [B,H,hd], k_pages, v_pages, block_tables, lens)`` is the
    paged attention: ``None`` takes the CUDA kernel wrapper
    ``kernels.ops.paged_decode_attention`` (its plain version on CPU
    tensors); ``kernels.ops.paged_decode_attention_plain`` forces the
    plain version, for comparisons. The arenas are updated in place and
    returned. The batch shape is the engine's fixed slot count: admitting
    or retiring a request changes only row contents, never a shape.
    """
    if cfg.family not in transformer.DECODER_FAMILIES:
        raise ValueError(
            f"paged decode in the port supports the dense transformer, not "
            f"{cfg.family} (MoE is a later slice of the port; SSM/hybrid "
            f"state is not block-addressable)")

    @torch.no_grad()
    def paged_serve_step(params, arenas, block_tables, token, cache_len):
        logits, new_arenas = transformer.forward(
            params, cfg, token, cache_len=cache_len,
            paged_cache=(arenas["k"], arenas["v"], block_tables),
            attend=attend)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_arenas

    return paged_serve_step
