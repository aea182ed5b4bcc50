"""Minimal functional parameter system of the PyTorch port (the counterpart
of ``repro.models.module``).

Parameters are plain nested dicts of tensors. Initialisation is name-keyed:
every parameter draws from its own ``torch.Generator`` seeded by a stable
hash of ``(seed, path)``, so adding parameters never reshuffles existing
ones. The values differ from ``jax.random``'s for the same seed; the
distributions are the same (normal with std ``fan_in ** -0.5``, zeros,
ones). Tests that compare the two packages bridge the JAX
parameters instead (``repro_torch.weights.from_jax_params``).
"""
from __future__ import annotations

import hashlib
from typing import Callable

import torch


def _name_seed(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8)
                          .digest(), "big") >> 1


class ParamBuilder:
    """Builds one subtree of parameters. ``dtype_of(path)`` gives the dtype a
    parameter is held in (``repro_torch.weights.held_dtype``); values are
    drawn in float32 on ``device`` and cast once."""

    def __init__(self, seed: int, dtype_of: Callable[[str], torch.dtype],
                 device, path: str = ""):
        self.seed = int(seed)
        self.dtype_of = dtype_of
        self.device = torch.device(device)
        self.path = path
        self.params: dict = {}

    def sub(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.seed, self.dtype_of, self.device,
                             f"{self.path}/{name}")
        self.params[name] = child.params
        return child

    def _generator(self, name: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_name_seed(f"{self.seed}:{self.path}/{name}"))
        return g

    def param(self, name: str, shape, init: str = "normal",
              scale: float | None = None) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        dtype = self.dtype_of(f"{self.path}/{name}")
        kw = dict(dtype=torch.float32, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            s = scale if scale is not None else fan_in ** -0.5
            v = torch.randn(shape, generator=self._generator(name), **kw) * s
        elif init == "zeros":
            v = torch.zeros(shape, **kw)
        elif init == "ones":
            v = torch.ones(shape, **kw)
        else:
            raise ValueError(init)
        v = v.to(dtype)
        self.params[name] = v
        return v


def _stack_into(stacked: dict, layer: dict, i: int) -> None:
    for k, v in layer.items():
        if isinstance(v, dict):
            _stack_into(stacked[k], v, i)
        else:
            stacked[k][i].copy_(v)


def _empty_stacked(layer: dict, n: int) -> dict:
    return {k: (_empty_stacked(v, n) if isinstance(v, dict)
                else v.new_empty((n,) + tuple(v.shape)))
            for k, v in layer.items()}


def stack_layers(seed: int, dtype_of, device, n: int,
                 build_one: Callable[[ParamBuilder, int], None]) -> dict:
    """Init ``n`` structurally identical layers and stack every leaf into
    ``[n, ...]``. Layers are built one at a time into the preallocated
    stack, so the peak is the stack plus one layer, not two stacks."""
    stacked = None
    for i in range(n):
        pb = ParamBuilder(seed, dtype_of, device, path=f"layer{i}")
        build_one(pb, i)
        if stacked is None:
            stacked = _empty_stacked(pb.params, n)
        _stack_into(stacked, pb.params, i)
    return stacked


def layer_slice(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a stacked ``[L, ...]`` parameter tree."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}
