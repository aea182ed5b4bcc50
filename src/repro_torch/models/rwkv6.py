"""RWKV-6 "Finch" of the PyTorch port (the counterpart of
``repro.models.rwkv6``): an attention-free LM whose time mix runs the WKV
recurrence

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with a data-dependent decay ``w_t = exp(-exp(w0 + lora_w(x~_t)))`` and
token-shift (ddlerp) inputs; its channel mix is a squared-ReLU MLP.

Training and prefill run the chunked WKV (``kernels.ops.rwkv6_wkv``: K5
forward and K5b backward on CUDA tensors); decoding runs the O(1)-state
recurrence :func:`wkv6_step` in plain torch, as the reference does outside
any Pallas kernel. The reference's ``lax.scan`` over layers is a Python
loop over the stacked ``[L, ...]`` parameters here. The casts follow the
reference: the LoRAs and projections in the compute dtype, the decay's
exponent and the bonus in float32, ``ln_x`` over the whole width.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch import weights
from repro_torch.config import Family, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import (
    ParamBuilder, checkpoint_layer, layer_slice, stack_layers, unstack_layers,
)
from repro_torch.sharding import constrain, splittable

LORA_W = 64
LORA_MIX = 32


# ---------------------------------------------------------------- decode ----

def wkv6_step(r, k, v, w, u, s):
    """One decode step. r, k, v, w [b,h,d]; u [h,d]; s [b,h,d,d] float32
    -> (o [b,h,d] in r's dtype, s')."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    kv = torch.einsum("bhc,bhd->bhcd", kf, vf)
    o = torch.einsum("bhc,bhcd->bhd", rf,
                     s + u.float()[None, :, :, None] * kv)
    return o.to(r.dtype), s * wf[..., None] + kv


# --------------------------------------------------------------- layers -----

def _init_time_mix(pb: ParamBuilder, cfg: ModelConfig) -> None:
    D = cfg.d_model
    t = pb.sub("tmix")
    t.param("mix_base", (D,), ("embed",), init="zeros")
    t.param("mix_lora_A", (D, LORA_MIX), ("embed", None))
    t.param("mix_lora_B", (5, LORA_MIX, D), (None, None, "embed"),
            init="zeros")
    t.param("mix_mu", (5, D), (None, "embed"), init="zeros")
    t.param("decay_base", (D,), ("embed",), init="zeros")
    t.param("decay_lora_A", (D, LORA_W), ("embed", None))
    t.param("decay_lora_B", (LORA_W, D), (None, "embed"), init="zeros")
    t.param("bonus", (D,), ("embed",), init="zeros")
    for nm in ("wr", "wk", "wv", "wg"):
        t.param(nm, (D, D), ("embed", "heads_flat"))
    t.param("wo", (D, D), ("heads_flat", "embed"))
    t.param("ln_x", (D,), ("embed",), init="ones")


def _init_channel_mix(pb: ParamBuilder, cfg: ModelConfig) -> None:
    D, Fd = cfg.d_model, cfg.d_ff
    m = pb.sub("cmix")
    m.param("mu_k", (D,), ("embed",), init="zeros")
    m.param("mu_r", (D,), ("embed",), init="zeros")
    m.param("wk", (D, Fd), ("embed", "mlp"))
    m.param("wv", (Fd, D), ("mlp", "embed"))
    m.param("wr", (D, D), ("embed", "embed2"))


def _shift(x, last):
    """Token shift: x_{t-1}, with ``last [B,1,D]`` at t = 0.
    Returns (shifted [B,L,D], new last [B,1,D])."""
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def time_mix(p, cfg: ModelConfig, x, *, shift_state, wkv_state=None,
             decode: bool = False, wkv=None, rules=None):
    """x [B,L,D] (L = 1 in decode). Returns ``(out, new_shift,
    new_wkv_state)``.

    Chunked (``decode=False``): the WKV through ``wkv(r, k, v, w, u) ->
    (o, s_final)`` (default ``ops.rwkv6_wkv``, K5/K5b on CUDA tensors;
    ``kernels.rwkv6_scan.wkv6_chunked_plain`` is the plain version) from a
    zero state: no path of the port carries one into a chunked call, so
    ``wkv_state`` must be None. Decode: one token against ``wkv_state
    [B,H,hd,hd]`` float32 through :func:`wkv6_step`. ``rules``: the
    reference's sharding constraint on the output."""
    dt_ = x.dtype
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    t = p["tmix"]
    prev, new_shift = _shift(x, shift_state)
    dx = prev - x
    # ddlerp: 5 interpolated views (w, k, v, r, g)
    base = x + dx * t["mix_base"].to(dt_)
    # the einsum merges dims m and d of mix_lora_B (forward) and of its
    # output's gradient (backward): d whole in both
    lora = L.pinned(torch.einsum("blr,mrd->mbld",
                                 torch.tanh(L.proj(base, t["mix_lora_A"])),
                                 L.mergeable(t["mix_lora_B"], 0).to(dt_)))
    mixed = x[None] + dx[None] * (t["mix_mu"].to(dt_)[:, None, None] + lora)
    xw, xk, xv, xr, xg = mixed.unbind(0)

    dw = L.proj(torch.tanh(L.proj(xw, t["decay_lora_A"])), t["decay_lora_B"])
    w = torch.exp(-torch.exp(t["decay_base"].float() + dw.float()))
    r, k, v, g = (L.proj(xi, t[n]) for xi, n in
                  ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    hsplit = lambda z: splittable(z, -1, H).reshape(*z.shape[:-1], H, hd)
    u = hsplit(t["bonus"].float())
    if decode:
        o, new_state = wkv6_step(hsplit(r)[:, 0], hsplit(k)[:, 0],
                                 hsplit(v)[:, 0], hsplit(w)[:, 0], u,
                                 wkv_state)
        o = o[:, None]
    else:
        if wkv_state is not None:
            raise ValueError("the chunked WKV starts from a zero state")
        o, new_state = (wkv or ops.rwkv6_wkv)(hsplit(r), hsplit(k),
                                              hsplit(v), hsplit(w), u)
    # the backward splits D into heads again
    o = L.pinned(L.mergeable(o, o.dim() - 2).reshape(*o.shape[:-2], D))
    o = L.rmsnorm(o, t["ln_x"]) * F.silu(g)
    out = constrain(L.proj(o, t["wo"]), rules, "batch", "seq", "embed")
    return out, new_shift, new_state


def channel_mix(p, cfg: ModelConfig, x, *, shift_state, rules=None):
    """The squared-ReLU MLP over token-shifted inputs. Returns ``(out,
    new_shift)``. ``rules``: the reference's sharding constraints."""
    dt_ = x.dtype
    m = p["cmix"]
    prev, new_shift = _shift(x, shift_state)
    dx = prev - x
    xk = x + dx * m["mu_k"].to(dt_)
    xr = x + dx * m["mu_r"].to(dt_)
    kk = constrain(torch.square(torch.relu(L.proj(xk, m["wk"]))), rules,
                   "batch", "seq", "mlp")
    rr = torch.sigmoid(L.proj(xr, m["wr"]))
    return constrain(rr * L.proj(kk, m["wv"]), rules, "batch", "seq",
                     "embed"), new_shift


# ------------------------------------------------------------------ model ---

def init(cfg: ModelConfig, *, seed: int = 0, device="cuda",
         master: bool = False) -> dict:
    """rwkv6: ``n_layers`` blocks (time mix, channel mix, ``ln1``, ``ln2``)
    stacked ``[L, ...]`` under ``blocks``. Random from ``seed`` on
    ``device``, each parameter held in ``weights.held_dtype`` (``master``:
    all in params dtype, for training; ``meta``: shapes and dtypes
    only)."""
    return _build(cfg, seed, device, master).params


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter, in the tree of :func:`init`."""
    return _build(cfg, 0, "meta", True).axes


def _build(cfg: ModelConfig, seed, device, master) -> ParamBuilder:
    if cfg.family != Family.SSM:
        raise ValueError(f"rwkv6.init builds the SSM family, not "
                         f"{cfg.family}")
    dtype_of = partial(weights.held_dtype, cfg=cfg, master=master)
    pb = ParamBuilder(seed, dtype_of, device)
    pb.param("embed", (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
             scale=1.0)

    def one(lpb: ParamBuilder, i: int):
        _init_time_mix(lpb, cfg)
        _init_channel_mix(lpb, cfg)
        lpb.param("ln1", (cfg.d_model,), ("embed",), init="ones")
        lpb.param("ln2", (cfg.d_model,), ("embed",), init="ones")
    pb.params["blocks"], pb.axes["blocks"] = stack_layers(
        seed, dtype_of, device, cfg.n_layers, one)
    pb.param("final_norm", (cfg.d_model,), ("embed",), init="ones")
    pb.param("lm_head", (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"))
    return pb


def forward(params, cfg: ModelConfig, tokens, *, embeds=None, positions=None,
            cache_len=None, cache=None,
            kernels: ops.Kernels = ops.KERNELS, rules=None):
    """rwkv6 over ``tokens [B,S]`` int: without a cache, the training and
    prefill forward; with one, one decode step.

    No cache: every block from a zero token shift and WKV state, the WKV
    through ``kernels.wkv`` (:func:`time_mix`), each block under
    activation checkpointing unless ``cfg.remat`` is "none" (the
    reference's ``jax.checkpoint(body)``). Returns ``(logits [B,S,V] float32, None)``.

    Decode: tokens [B,1] and ``cache`` (:func:`init_cache`): ``wkv
    [L,B,H,hd,hd]`` float32, ``shift1`` and ``shift2 [L,B,1,D]`` (the time
    and channel mixes' last inputs). Every leaf is updated IN PLACE (the
    reference returns new arrays) and the cache returned. Returns
    ``(logits [B,1,V] float32, cache)``.

    ``embeds``, ``positions`` and ``cache_len`` are taken so the families
    share one signature: rwkv6 has no patch prefix and refuses one, and
    needs no positions. The other fields of ``kernels`` are other
    families'. ``rules``: the reference's sharding constraints."""
    if embeds is not None:
        raise ValueError(f"{cfg.arch_id} takes no embeds prefix")
    x = constrain(L.embed(params["embed"], tokens,
                          weights.torch_dtype(cfg.compute_dtype)),
                  rules, "batch", "seq", "embed")
    B, S, D = x.shape
    if cache is not None:
        for li in range(cfg.n_layers):
            lp = layer_slice(params["blocks"], li)
            tm, s1, st = time_mix(lp, cfg, L.rmsnorm(x, lp["ln1"]),
                                  shift_state=cache["shift1"][li],
                                  wkv_state=cache["wkv"][li], decode=True,
                                  rules=rules)
            x = x + tm
            cm, s2 = channel_mix(lp, cfg, L.rmsnorm(x, lp["ln2"]),
                                 shift_state=cache["shift2"][li],
                                 rules=rules)
            x = x + cm
            cache["wkv"][li].copy_(st)
            cache["shift1"][li].copy_(s1)
            cache["shift2"][li].copy_(s2)
    else:
        zero1 = x.new_zeros((B, 1, D))

        def block(lp, h):
            tm, _, _ = time_mix(lp, cfg, L.rmsnorm(h, lp["ln1"]),
                                shift_state=zero1, wkv=kernels.wkv,
                                rules=rules)
            h = h + tm
            cm, _ = channel_mix(lp, cfg, L.rmsnorm(h, lp["ln2"]),
                                shift_state=zero1, rules=rules)
            return h + cm
        block = checkpoint_layer(cfg, block)
        for lp in unstack_layers(params["blocks"], cfg.n_layers):
            x = block(lp, x)
    x = L.rmsnorm(x, params["final_norm"])
    logits = constrain(L.proj(x, params["lm_head"]), rules, "batch",
                       "seq", "vocab")
    return logits.float(), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", kv_rep: int = 1) -> dict:
    """Zeros: ``wkv [L,batch,H,hd,hd]`` float32 and ``shift1``, ``shift2
    [L,batch,1,D]`` in the compute dtype. The state is O(1) in the
    sequence, so ``max_len`` is unused. The shifts are held in the compute
    dtype because the decode step writes them in place: the reference's
    cache holds them in bf16 only until its first step returns them in the
    compute dtype, and an f32 model's shifted token would otherwise be
    rounded to bf16. ``kv_rep`` is taken so the families share one
    signature: rwkv6 has no KV heads."""
    del max_len, kv_rep
    dtype = weights.torch_dtype(cfg.compute_dtype)
    shift = (cfg.n_layers, batch, 1, cfg.d_model)
    return {
        "wkv": torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.hd,
                            cfg.hd), dtype=torch.float32, device=device),
        "shift1": torch.zeros(shift, dtype=dtype, device=device),
        "shift2": torch.zeros(shift, dtype=dtype, device=device),
    }


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_cache`'s tree."""
    return {"wkv": ("stack", "batch", "heads", None, None),
            "shift1": ("stack", "batch", None, "embed"),
            "shift2": ("stack", "batch", None, "embed")}
