"""Weight layout of the PyTorch port, and the bridge from the JAX package.

Parameters are nested dicts of tensors in the JAX package's layout
(``transformer.init``): ``embed [V,D]``, per-layer leaves stacked
``[L, ...]`` under ``blocks``, ``final_norm [D]``, ``lm_head [D,V]``.

Held dtype: the reference keeps every parameter in ``params_dtype``
(float32) and casts each matrix to ``compute_dtype`` right before its only
use (``.astype(dt)`` in ``models/layers.py`` and ``models/transformer.py``).
The port holds every matrix and bias once in ``compute_dtype`` instead,
which gives the same values at the point of use and halves the weights
(starcoder2-7b: 7.4 B parameters at 2 bytes each in bf16 instead of 4 in
float32). The norm scales stay in ``params_dtype``: ``rmsnorm`` reads them
as float32.
"""
from __future__ import annotations

import numpy as np
import torch

NORM_SCALES = ("ln_attn", "ln_mlp", "final_norm")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (``"bfloat16"``, ...)."""
    return _DTYPES[str(name)]


def held_dtype(path: str, cfg) -> torch.dtype:
    """The dtype the port holds the parameter at ``path`` in."""
    name = path.rsplit("/", 1)[-1]
    return torch_dtype(cfg.params_dtype if name in NORM_SCALES
                       else cfg.compute_dtype)


def from_jax_params(params_np, cfg, device="cuda", path: str = "") -> dict:
    """Turn the JAX parameter tree (dicts whose leaves are numpy arrays, as
    ``np.asarray`` gives them from ``repro.models.transformer.init``) into
    the port's parameters on ``device``, each in its held dtype."""
    out = {}
    for name, leaf in params_np.items():
        p = f"{path}/{name}"
        if isinstance(leaf, dict):
            out[name] = from_jax_params(leaf, cfg, device, p)
            continue
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":     # numpy has no bf16: widen exactly
            a = a.astype(np.float32)
        out[name] = torch.from_numpy(a.copy()).to(
            device=device, dtype=held_dtype(p, cfg))
    return out
