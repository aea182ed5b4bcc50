"""Gradient compression for cross-pod reduction (the counterpart of
``repro.optim.compression``), over nested dicts of tensors.

 * bf16: simple down-cast (2x wire reduction, no state)
 * int8_ef: blockwise int8 quantization (blocks of 256, one f32 scale
   each) with error feedback: the residual of each quantization is
   carried and added to the next step's gradient, preserving convergence
   (1-bit-Adam-style EF).

:func:`all_reduce_tree` sums a tree over a process group in compressed
form: the bf16 payload by one all-reduce per leaf, the int8 one by
gathering every rank's blocks and scales and summing them dequantised.
"""
from __future__ import annotations

import math

import torch

BLOCK = 256


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _quant_int8(x):
    """x -> (q [n_blocks, 256] int8, scale [n_blocks, 1] float32)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # by a tensor, not the number 127: PyTorch divides a CUDA tensor by a
    # number as a product with its reciprocal, which can round otherwise
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_int8(q, scale, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_tree(grads, method: str, error_state=None):
    """Returns ``(payload, new_error_state)``; the payload is what goes on
    the wire. int8_ef's payload has the tree's structure with a ``(q,
    scale, shape)`` tuple at every leaf, and the error state is the f32
    residual of each leaf (zeros when ``error_state`` is None)."""
    if method == "none":
        return grads, error_state
    if method == "bf16":
        return _tree_map(lambda g: g.to(torch.bfloat16), grads), error_state
    if method == "int8_ef":
        if error_state is None:
            error_state = _tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
        out = _tree_map(_quant_leaf, grads, error_state)
        return (_tree_map(lambda o: o[0], out),
                _tree_map(lambda o: o[1], out))
    raise ValueError(method)


def _quant_leaf(g, e):
    corrected = g.to(torch.float32) + e
    q, s = _quant_int8(corrected)
    deq = _dequant_int8(q, s, tuple(g.shape))
    return (q, s, tuple(g.shape)), corrected - deq


def decompress_tree(payload, method: str):
    if method == "none":
        return payload
    if method == "bf16":
        return _tree_map(lambda g: g.to(torch.float32), payload)
    if method == "int8_ef":
        return _tree_map(lambda p: _dequant_int8(*p), payload)
    raise ValueError(method)


def all_reduce_tree(grads, method: str, group=None, error_state=None):
    """The sum of ``grads`` over ``group``'s ranks, sent compressed by
    ``method``. Returns ``(summed tree, new_error_state)``, the sum in f32
    for "bf16" and "int8_ef"."""
    import torch.distributed as dist

    payload, error_state = compress_tree(grads, method, error_state)
    if method in ("none", "bf16"):
        def reduce(t):
            t = t.clone()
            dist.all_reduce(t, group=group)
            return t
        return decompress_tree(_tree_map(reduce, payload), method), \
            error_state

    world = dist.get_world_size(group)

    def gather_sum(p):
        q, s, shape = p
        qs = [torch.empty_like(q) for _ in range(world)]
        ss = [torch.empty_like(s) for _ in range(world)]
        dist.all_gather(qs, q, group=group)
        dist.all_gather(ss, s, group=group)
        return sum(_dequant_int8(qi, si, shape) for qi, si in zip(qs, ss))
    return _tree_map(gather_sum, payload), error_state
