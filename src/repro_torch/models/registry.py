"""Model-family registry of the PyTorch port (the counterpart of
``repro.models.registry``): family -> (init, forward, init_cache,
cache_axes, param_axes).

The port has every family of the reference: the dense transformer, the
VLM's backbone (the same decoder; the patch-embed prefix is precomputed),
the MoE transformer (the same decoder with ``moe_mlp`` for the MLP), the
zamba2 hybrid, the SSM (rwkv6) and the encoder-decoder (seamless; the
audio frontend is precomputed frame embeddings).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable

from repro_torch import port_configs
from repro_torch.config import Family, ModelConfig
from repro_torch.models import encdec, mamba2, rwkv6, transformer


@dataclass(frozen=True)
class ModelApi:
    init: Callable
    forward: Callable
    init_cache: Callable
    cache_axes: Callable     # cfg -> the logical axes of init_cache's tree
    param_axes: Callable     # cfg -> the logical axes of init's tree


def _api(module) -> ModelApi:
    return ModelApi(module.init, module.forward, module.init_cache,
                    module.cache_axes, module.param_axes)


_BY_FAMILY = {
    Family.DENSE: _api(transformer),
    Family.VLM: _api(transformer),
    Family.MOE: _api(transformer),
    Family.HYBRID: _api(mamba2),
    Family.SSM: _api(rwkv6),
    Family.ENCDEC: _api(encdec),
}


def get_api(cfg: ModelConfig) -> ModelApi:
    """The family's functions. Where ``cfg`` is a plain ``ModelConfig``
    that names a preset of ``port_configs`` (a configuration file gives
    only the shared fields), each function is called with
    ``port_configs.resolve(cfg)`` in place of the config it is given."""
    api = _BY_FAMILY[cfg.family]
    full = port_configs.resolve(cfg)
    if full is cfg:
        return api
    return ModelApi(*(_taking(full, getattr(api, f.name))
                      for f in fields(api)))


def _taking(full: ModelConfig, fn: Callable) -> Callable:
    def call(cfg, *args, **kwargs):
        return fn(full, *args, **kwargs)
    return call
