"""Model-family registry of the PyTorch port (the counterpart of
``repro.models.registry``): family -> (init, forward, init_cache).

The port has the dense transformer, the VLM's backbone (the same decoder;
the patch-embed prefix is precomputed) and the zamba2 hybrid. MoE, the
SSM (rwkv6) and the encoder-decoder are the other-families slice of the
port, and :func:`get_api` refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.config import Family, ModelConfig
from repro_torch.models import mamba2, transformer


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
    Family.HYBRID: ModelApi(mamba2.init, mamba2.forward, mamba2.init_cache),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    """The family's functions, or ValueError for a family the port does
    not have yet."""
    api = _BY_FAMILY.get(cfg.family)
    if api is None:
        raise ValueError(
            f"the port has the dense transformer, the VLM backbone and the "
            f"zamba2 hybrid, not {cfg.family}: MoE, SSM and the "
            f"encoder-decoder are the other-families slice of the port")
    return api
