"""Weight layout of the PyTorch port, and the bridge from the JAX package.

Parameters are nested dicts of tensors in the JAX package's layout
(``transformer.init``): ``embed [V,D]``, per-layer leaves stacked
``[L, ...]`` under ``blocks``, ``final_norm [D]``, ``lm_head [D,V]``.

Held dtype: the reference keeps every parameter in ``params_dtype``
(float32) and casts each matrix to ``compute_dtype`` right before its only
use (``.astype(dt)`` in ``models/layers.py`` and ``models/transformer.py``).
For serving, the port holds every matrix and bias once in
``compute_dtype`` instead, which gives the same values at the point of use
and halves the weights (starcoder2-7b: 7.4 B parameters at 2 bytes each in
bf16 instead of 4 in float32). The norm scales stay in ``params_dtype``:
``rmsnorm`` reads them as float32. For training (``master=True``) every
parameter is held in ``params_dtype``, as the reference holds it: AdamW
updates the float32 values, and a bf16-held weight would lose most of each
``lr * step`` to rounding; the forward casts each matrix at its use.
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


def held_dtype(path: str, cfg, master: bool = False) -> torch.dtype:
    """The dtype the port holds the parameter at ``path`` in:
    ``params_dtype`` for master weights (training) and norm scales,
    ``compute_dtype`` for the other serving weights."""
    name = path.rsplit("/", 1)[-1]
    return torch_dtype(cfg.params_dtype if master or name in NORM_SCALES
                       else cfg.compute_dtype)


def from_jax_params(params_np, cfg, device="cuda", path: str = "", *,
                    master: bool = False) -> dict:
    """Turn the JAX parameter tree (dicts whose leaves are numpy arrays, as
    ``np.asarray`` gives them from ``repro.models.transformer.init``) into
    the port's parameters on ``device``, each in its held dtype
    (``master``: see :func:`held_dtype`)."""
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
