"""input_specs of the PyTorch port (the counterpart of
``repro.launch.specs``): ``meta`` tensors standing in for every model
input, per (arch x shape) cell, with the reference's shapes and dtypes.
Nothing is allocated.
"""
from __future__ import annotations

import torch

from repro_torch import weights
from repro_torch.config import Family, ModelConfig, ShapeConfig, ShapeKind
from repro_torch.models.registry import get_api

I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Train/prefill batch dict of meta tensors."""
    B, S = shape.global_batch, shape.seq_len
    dt = weights.torch_dtype(cfg.compute_dtype)
    out = {}
    if cfg.family == Family.VLM:
        P = cfg.n_patch_tokens
        out["embeds"] = _meta((B, P, cfg.d_model), dt)
        out["tokens"] = _meta((B, S - P), I32)
        if shape.kind == ShapeKind.TRAIN:
            out["labels"] = _meta((B, S - P), I32)
        return out
    if cfg.family == Family.ENCDEC:
        out["embeds"] = _meta((B, S, cfg.d_model), dt)   # frame embeddings
        out["tokens"] = _meta((B, S), I32)
        if shape.kind == ShapeKind.TRAIN:
            out["labels"] = _meta((B, S), I32)
        return out
    out["tokens"] = _meta((B, S), I32)
    if shape.kind == ShapeKind.TRAIN:
        out["labels"] = _meta((B, S), I32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 kv_rep: int = 1) -> dict:
    """serve_step inputs: one new token + a seq_len KV/state cache."""
    B, S = shape.global_batch, shape.seq_len
    out = {
        "cache": get_api(cfg).init_cache(cfg, B, S, device="meta",
                                         kv_rep=kv_rep),
        "token": _meta((B, 1), I32),
        "cache_len": _meta((B,), I32),
    }
    if cfg.family == Family.ENCDEC:
        out["enc_out"] = _meta((B, min(S, 4096), cfg.d_model),
                               weights.torch_dtype(cfg.compute_dtype))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                kv_rep: int = 1) -> dict:
    if shape.kind == ShapeKind.DECODE:
        return decode_specs(cfg, shape, kv_rep=kv_rep)
    return batch_specs(cfg, shape)
