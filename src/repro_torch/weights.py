"""Weight layout of the PyTorch port, and the bridge from the JAX package.

Parameters are nested dicts of tensors in the JAX package's layout
(``transformer.init``, ``mamba2.init``, ``rwkv6.init``, ``encdec.init``):
``embed [V,D]``,
per-layer leaves stacked ``[L, ...]`` under ``blocks`` (an MoE layer's
``moe/router [D,E]``, ``moe/wi_gate``, ``moe/wi_up [E,D,F]`` and
``moe/wo [E,F,D]``, and arctic's ``dense_mlp``), the hybrid's ``shared``
block, ``final_norm [D]``, ``lm_head [D,V]``; the encoder-decoder's
``encoder`` stack ``[n_enc_layers, ...]`` (``attn``, ``mlp``, ``ln_attn``,
``ln_mlp``), ``decoder`` stack ``[n_layers, ...]`` (``self_attn``,
``cross_attn``, ``mlp``, ``ln_self``, ``ln_cross``, ``ln_mlp``) and
``enc_norm``.

Held dtype: the reference keeps every parameter in ``params_dtype``
(float32) and casts each matrix to ``compute_dtype`` right before its only
use (``.astype(dt)`` in ``models/layers.py`` and ``models/transformer.py``).
For serving, the port holds every matrix and bias once in
``compute_dtype`` instead, which gives the same values at the point of use
and halves the weights (starcoder2-7b: 7.4 B parameters at 2 bytes each in
bf16 instead of 4 in float32). The leaves the reference reads as float32
stay in ``params_dtype``: the norm scales (``rmsnorm`` reads them as
float32; the mamba blocks' ``ln`` and gated ``mamba/norm`` among them) and
the mamba blocks' ``mamba/A_log`` and ``mamba/dt_bias``, which enter the
scan's decay in float32, and the rwkv6 blocks' ``ln1``, ``ln2`` and
``tmix/ln_x`` (norm scales) and ``tmix/decay_base`` and ``tmix/bonus``,
which enter the WKV's decay and bonus in float32, and the
encoder-decoder's ``decoder/ln_self``, ``decoder/ln_cross`` and
``enc_norm`` (norm scales). An MoE layer's router is held in the compute
dtype like the expert matrices: the reference casts it to the compute
dtype before the routing einsum. They are told by their path, not by a
name alone
(:data:`FLOAT32_PATH`). For training (``master=True``) every
parameter is held in ``params_dtype``, as the reference holds it: AdamW
updates the float32 values, and a bf16-held weight would lose most of each
``lr * step`` to rounding; the forward casts each matrix at its use.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# the leaves held in params_dtype for serving: the transformer's norm
# scales anywhere (the encoder-decoder's ln_self, ln_cross and enc_norm
# among them); a mamba block's own ln (a leaf of a layer, "blocks/" in
# the stacked tree, "layer<i>/" while it is built) and its gated norm,
# A_log and dt_bias; an rwkv6 block's ln1, ln2 and time-mix ln_x (norm
# scales) and its decay_base and bonus (read as float32 into the WKV)
FLOAT32_PATH = re.compile(r"(^|/)(ln_attn|ln_mlp|ln_self|ln_cross"
                          r"|final_norm|enc_norm"
                          r"|(blocks|layer\d+)/(ln|ln1|ln2)"
                          r"|mamba/(norm|A_log|dt_bias)"
                          r"|tmix/(ln_x|decay_base|bonus))$")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (``"bfloat16"``, ...)."""
    return _DTYPES[str(name)]


def held_dtype(path: str, cfg, master: bool = False) -> torch.dtype:
    """The dtype the port holds the parameter at ``path`` in:
    ``params_dtype`` for master weights (training) and for the leaves
    :data:`FLOAT32_PATH` matches, ``compute_dtype`` for the other serving
    weights."""
    return torch_dtype(cfg.params_dtype if master or FLOAT32_PATH.search(path)
                       else cfg.compute_dtype)


def from_jax_params(params_np, cfg, device="cuda", path: str = "", *,
                    master: bool = False) -> dict:
    """Turn the JAX parameter tree (dicts whose leaves are numpy arrays, as
    ``np.asarray`` gives them from ``repro.models.transformer.init`` of a
    dense, VLM or MoE config, ``repro.models.mamba2.init``,
    ``repro.models.rwkv6.init`` or ``repro.models.encdec.init``) into the
    port's parameters on ``device``, each in its held dtype (``master``:
    see :func:`held_dtype`). Every family's tree goes through unchanged:
    same paths, same shapes."""
    out = {}
    for name, leaf in params_np.items():
        p = f"{path}/{name}"
        if isinstance(leaf, dict):
            out[name] = from_jax_params(leaf, cfg, device, p, master=master)
            continue
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":     # numpy has no bf16: widen exactly
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(a.copy()).to(
            device=device, dtype=held_dtype(p, cfg, master))
    return out


def to_numpy_tree(tree):
    """The port's nested dicts of tensors as nested dicts of numpy arrays
    on the host (bf16 widened to float32, exactly), for comparisons with
    the JAX package."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
