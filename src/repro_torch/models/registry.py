"""Model-family registry of the PyTorch port (the counterpart of
``repro.models.registry``): family -> (init, forward, init_cache).

The port has the dense transformer, the VLM's backbone (the same decoder;
the patch-embed prefix is precomputed), the MoE transformer (the same
decoder with ``moe_mlp`` for the MLP), the zamba2 hybrid and the SSM
(rwkv6). The encoder-decoder is the other-families slice of the port,
and :func:`get_api` refuses it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.config import Family, ModelConfig
from repro_torch.models import mamba2, rwkv6, transformer


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
}


def get_api(cfg: ModelConfig) -> ModelApi:
    """The family's functions, or ValueError for a family the port does
    not have yet."""
    api = _BY_FAMILY.get(cfg.family)
    if api is None:
        raise ValueError(
            f"the port has the dense transformer, the VLM backbone, the "
            f"MoE transformer, the zamba2 hybrid and the rwkv6 SSM, not "
            f"{cfg.family}: the encoder-decoder is the other-families slice "
            f"of the port")
    return api
