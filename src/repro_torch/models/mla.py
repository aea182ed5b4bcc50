"""Multi-head latent attention (MLA) of DeepSeek-V2/V3 (arXiv:2405.04434
§2.1), as ``port_configs.MlaMoeConfig`` gives it (``q_lora_rank`` null);
the JAX package has no counterpart. For x [B,S,D]:

  q = x W_q                        [B,S,H,dn + dr]: dn no-RoPE, dr RoPE dims
  c, k_r = split(x W_kva)          [B,S,R], [B,S,dr]: the latent and one
                                   RoPE key shared by all heads
  k_n, v = split(rmsnorm(c) W_kvb) [B,S,H,dn], [B,S,H,dv]
  q_r, k_r rotated (``layers.apply_rope`` over the dr dims alone)
  o = softmax(q k^T / sqrt(dn + dr)) v, causal, with k = [k_n, k_r]
  y = o W_o                        [B,S,D]

Without a cache only (training and prefill): the keys and values are
decompressed, and the attention runs through ``attend`` (default
``ops.flash_attention``: K3a/K3b at a query/key head dim of dn + dr and a
value head dim of dv on CUDA tensors).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import AttentionStep, proj
from repro_torch.sharding import constrain


def init_attention(pb, cfg, prefix: str = "attn"):
    D, H, R = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    a = pb.sub(prefix)
    a.param("wq", (D, H, cfg.qk_head_dim), ("embed", "heads", "head_dim"))
    a.param("wkv_a", (D, R + cfg.qk_rope_head_dim), ("embed", None))
    a.param("kv_norm", (R,), (None,), init="ones")
    a.param("wkv_b", (R, H, cfg.qk_nope_head_dim + cfg.v_head_dim),
            (None, "heads", "head_dim"))
    a.param("wo", (H, cfg.v_head_dim, D), ("heads", "head_dim", "embed"))


def nocache_step(cfg, positions) -> AttentionStep:
    """positions [B,S] int: the rotary tables of the RoPE dims."""
    return AttentionStep(*L.rope_tables(positions, cfg.qk_rope_head_dim,
                                        cfg.rope_theta))


def attention(p, cfg, x, *, step: AttentionStep, attend=None, rules=None):
    """Causal MLA over x [B,S,D] -> [B,S,D] (module docstring)."""
    B, S, _ = x.shape
    H, R = cfg.n_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    q = constrain(proj(x, p["wq"]), rules, "batch", "seq", "heads",
                  "head_dim")
    kv = proj(x, p["wkv_a"])
    c = L.rmsnorm(kv[..., :R], p["kv_norm"], cfg.rms_eps)
    k_r = L.apply_rope(kv[..., None, R:], step.cos, step.sin)
    kvb = proj(c, p["wkv_b"])
    q = torch.cat([q[..., :dn], L.apply_rope(q[..., dn:], step.cos,
                                             step.sin)], dim=-1)
    k = torch.cat([kvb[..., :dn], k_r.expand(B, S, H, k_r.shape[-1])],
                  dim=-1)
    v = kvb[..., dn:]
    out = (attend or ops.flash_attention)(q, k, v, causal=True)
    out = constrain(out, rules, "batch", "seq", "heads", "head_dim")
    wo = p["wo"].reshape(H * dv, -1)
    return constrain(proj(out.reshape(B, S, H * dv), wo), rules, "batch",
                     "seq", "embed")


def init_dense_mlp(pb, cfg, prefix: str = "mlp"):
    """The leading dense layers' SwiGLU of ``dense_d_ff``."""
    D, F_ = cfg.d_model, cfg.dense_d_ff
    m = pb.sub(prefix)
    m.param("wi_gate", (D, F_), ("embed", "mlp"))
    m.param("wi_up", (D, F_), ("embed", "mlp"))
    m.param("wo", (F_, D), ("mlp", "embed"))
