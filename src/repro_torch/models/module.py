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

import dataclasses
import hashlib
from functools import partial
from typing import Callable

import torch
from torch.utils import checkpoint as ckpt

# names of leaves that take part in no differentiable path (an MoE router's
# selection bias, ``moe.init_moe_dropless``): the train step does not mark
# them as requiring a gradient, and AdamW leaves them as they are
FROZEN = frozenset({"e_score_correction_bias"})


def _name_seed(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(), digest_size=8)
                          .digest(), "big") >> 1


class ParamBuilder:
    """Builds one subtree of parameters and their logical axes
    (``.params``, ``.axes``: the same tree). ``dtype_of(path)`` gives the
    dtype a parameter is held in (``repro_torch.weights.held_dtype``);
    values are drawn in float32 on ``device`` and cast once. On the
    ``meta`` device nothing is drawn."""

    def __init__(self, seed: int, dtype_of: Callable[[str], torch.dtype],
                 device, path: str = ""):
        self.seed = int(seed)
        self.dtype_of = dtype_of
        self.device = torch.device(device)
        self.path = path
        self.params: dict = {}
        self.axes: dict = {}

    def sub(self, name: str) -> "ParamBuilder":
        child = ParamBuilder(self.seed, self.dtype_of, self.device,
                             f"{self.path}/{name}")
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def _generator(self, name: str) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_name_seed(f"{self.seed}:{self.path}/{name}"))
        return g

    def param(self, name: str, shape, axes, init: str = "normal",
              scale: float | None = None) -> torch.Tensor:
        """A parameter of ``shape`` whose dims have the logical ``axes``
        (a name of ``sharding.ShardingRules`` or None each)."""
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"{self.path}/{name}: shape {shape} has "
                             f"{len(shape)} dims, axes {axes} name "
                             f"{len(axes)}")
        dtype = self.dtype_of(f"{self.path}/{name}")
        self.axes[name] = axes
        if init not in ("normal", "zeros", "ones"):
            raise ValueError(init)
        if self.device.type == "meta":
            v = torch.empty(shape, dtype=dtype, device=self.device)
            self.params[name] = v
            return v
        kw = dict(dtype=torch.float32, device=self.device)
        if init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            s = scale if scale is not None else fan_in ** -0.5
            v = torch.randn(shape, generator=self._generator(name), **kw) * s
        elif init == "zeros":
            v = torch.zeros(shape, **kw)
        else:
            v = torch.ones(shape, **kw)
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


def _stacked_axes(axes: dict) -> dict:
    return {k: (_stacked_axes(v) if isinstance(v, dict) else ("stack",) + v)
            for k, v in axes.items()}


def stack_layers(seed: int, dtype_of, device, n: int,
                 build_one: Callable[[ParamBuilder, int], None],
                 first: int = 0) -> tuple[dict, dict]:
    """Init ``n`` structurally identical layers and stack every leaf into
    ``[n, ...]``; the layer dim gets the logical axis "stack". Returns
    ``(stacked, axes)``. Layers are built one at a time into the
    preallocated stack, so the peak is the stack plus one layer, not two
    stacks; on ``meta`` only the first layer is built. Layer ``i`` draws
    as the model's layer ``first + i`` (a second stack of one model
    starts where the first ends)."""
    stacked = None
    for i in range(n):
        pb = ParamBuilder(seed, dtype_of, device, path=f"layer{first + i}")
        build_one(pb, i)
        if stacked is None:
            stacked = _empty_stacked(pb.params, n)
            axes = _stacked_axes(pb.axes)
            if pb.device.type == "meta":
                break
        _stack_into(stacked, pb.params, i)
    return stacked, axes


def layer_slice(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a stacked ``[L, ...]`` parameter tree."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def unstack_layers(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked ``[L, ...]`` tree as views, taken
    apart once with ``unbind(0)``: under autograd its backward stacks the
    layers' gradients once, where ``n`` single-layer selects would each
    fill a zero gradient as large as the whole stack."""
    layers = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = (unstack_layers(v, n) if isinstance(v, dict)
                 else v.unbind(0))
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


# products without a batch dim: XLA's dot_general with no batch
# dimensions, which the reference's remat="dots" saves
# (``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``). An
# einsum reaches aten.mm or, whatever its shapes, aten.bmm over a batch of
# one (``torch.einsum("bsd,dhk->bshk", ...)`` does); a bmm over more than
# one is a batched product (attention's scores and PV).
_PRODUCTS = {torch.ops.aten.mm.default: None, torch.ops.aten.addmm.default:
             None, torch.ops.aten.bmm.default: 0,
             torch.ops.aten.baddbmm.default: 1}


def save_products(ctx, op, *args, **kwargs):
    """The checkpoint policy of remat="dots": a layer keeps the outputs of
    its products that have no batch dim (the weight products: q, k, v, o
    and the MLP's) and recomputes everything else in the backward, the
    attention kernels' autograd functions included. Every product it
    keeps in a forward adds one to ``save_products.saved``."""
    if op in _PRODUCTS:
        batched_arg = _PRODUCTS[op]
        if batched_arg is None or args[batched_arg].shape[0] == 1:
            if not ctx.is_recompute:
                save_products.saved += 1
            return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


save_products.saved = 0


def remat(cfg, fn: Callable, policy: Callable | None = None) -> Callable:
    """``fn`` run as ``cfg.remat`` says (the reference's ``_remat`` of the
    transformer): "none" plainly; "full" under activation checkpointing
    (only the inputs are kept, the backward runs ``fn`` again); "dots"
    under selective checkpointing by ``policy`` (default
    :func:`save_products`), the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return partial(ckpt.checkpoint, fn, use_reentrant=False,
                       context_fn=partial(
                           ckpt.create_selective_checkpoint_contexts,
                           policy or save_products))
    raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")


def checkpoint_layer(cfg, fn: Callable) -> Callable:
    """``fn`` under activation checkpointing unless ``cfg.remat`` is
    "none": the reference's ``jax.checkpoint`` of a recurrent family's
    layer body and of the encoder-decoder's layers (the hybrid's mamba
    layers, rwkv6's blocks, seamless's encoder and decoder layers), for
    "full" and "dots" alike."""
    return remat(cfg if cfg.remat != "dots"
                 else dataclasses.replace(cfg, remat="full"), fn)
