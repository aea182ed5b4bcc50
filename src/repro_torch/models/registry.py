"""Model-family registry of the PyTorch port (the counterpart of
``repro.models.registry``): family -> (init, forward, init_cache).

The port has every family of the reference: the dense transformer, the
VLM's backbone (the same decoder; the patch-embed prefix is precomputed),
the MoE transformer (the same decoder with ``moe_mlp`` for the MLP), the
zamba2 hybrid, the SSM (rwkv6) and the encoder-decoder (seamless; the
audio frontend is precomputed frame embeddings).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.config import Family, ModelConfig
from repro_torch.models import encdec, mamba2, rwkv6, transformer


@dataclass(frozen=True)
class ModelApi:
    init: Callable
    forward: Callable
    init_cache: Callable


_BY_FAMILY = {
    Family.DENSE: ModelApi(transformer.init, transformer.forward,
                           transformer.init_cache),
    Family.VLM: ModelApi(transformer.init, transformer.forward,
                         transformer.init_cache),
    Family.MOE: ModelApi(transformer.init, transformer.forward,
                         transformer.init_cache),
    Family.HYBRID: ModelApi(mamba2.init, mamba2.forward, mamba2.init_cache),
    Family.SSM: ModelApi(rwkv6.init, rwkv6.forward, rwkv6.init_cache),
    Family.ENCDEC: ModelApi(encdec.init, encdec.forward, encdec.init_cache),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    """The family's functions."""
    return _BY_FAMILY[cfg.family]
