"""Plain reference of the DeepSeek-V3 layout as the configuration runs it
(``family: moe``, ``model_type`` deepseek_v3; arXiv:2412.19437 §2.1): token
embedding, ``first_k_dense_replace`` layers of latent attention (MLA) and a
dense SwiGLU, then layers of MLA and a mixture of experts, a final RMSNorm
and an untied output head, logits in float32.

MLA with ``q_lora_rank`` null: q = h W_q (``qk_nope_head_dim`` no-RoPE and
``qk_rope_head_dim`` RoPE dims a head); h W_kva gives the latent (RMSNorm
``kv_norm``) and one RoPE key for all heads; the latent times W_kvb gives
each head's no-RoPE key and its value; keys and values are decompressed and
attended causally at scale 1/sqrt(nope + rope).

The experts: float32 scores s = sigmoid(h W_r); each token's
``num_experts_per_tok`` experts are the largest of s + b (b the selection
bias; ties to the lower index), weighted by s over their sum and by
``routed_scaling_factor``. Every expert is a loop over the rows routed to
it, with no capacity and nothing dropped; the ``n_shared_experts`` shared
experts are one SwiGLU of their summed width on the same normed input.
The bias takes part in the choice alone: it enters the loss times zero so
that ``common.train`` gets a (zero) gradient for it."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import common as C


def _dims(cfg: dict) -> dict:
    F_ = cfg["moe_intermediate_size"]
    return {"L": cfg["num_hidden_layers"], "Ld": cfg["first_k_dense_replace"],
            "D": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "R": cfg["kv_lora_rank"], "dn": cfg["qk_nope_head_dim"],
            "dr": cfg["qk_rope_head_dim"], "dv": cfg["v_head_dim"],
            "E": cfg["n_routed_experts"], "F": F_,
            "Fs": cfg["n_shared_experts"] * F_,
            "Fd": cfg["intermediate_size"], "V": cfg["vocab_size"]}


def _attn(prefix: str, n: int, d: dict) -> list:
    D, H, R, dn, dr, dv = (d[k] for k in ("D", "H", "R", "dn", "dr", "dv"))
    return [(f"{prefix}/attn/wq", (n, D, H, dn + dr), "normal", D ** -0.5),
            (f"{prefix}/attn/wkv_a", (n, D, R + dr), "normal", D ** -0.5),
            (f"{prefix}/attn/kv_norm", (n, R), "ones", None),
            (f"{prefix}/attn/wkv_b", (n, R, H, dn + dv), "normal",
             R ** -0.5),
            (f"{prefix}/attn/wo", (n, H, dv, D), "normal", (H * dv) ** -0.5),
            (f"{prefix}/ln_attn", (n, D), "ones", None),
            (f"{prefix}/ln_mlp", (n, D), "ones", None)]


def _swiglu(prefix: str, n: int, D: int, F_: int) -> list:
    return [(f"{prefix}/wi_gate", (n, D, F_), "normal", D ** -0.5),
            (f"{prefix}/wi_up", (n, D, F_), "normal", D ** -0.5),
            (f"{prefix}/wo", (n, F_, D), "normal", F_ ** -0.5)]


def layout(cfg: dict) -> list:
    """The parameter leaves ``(path, shape, init, scale)``: the dense
    layers under ``dense_blocks``, the MoE layers under ``blocks``; the
    routed experts' gate and up products as one ``wi [E, D, 2F]``, gate
    columns first."""
    d = _dims(cfg)
    Ld, Lm, D, E, F_ = d["Ld"], d["L"] - d["Ld"], d["D"], d["E"], d["F"]
    out = [("embed", (d["V"], D), "normal", 1.0),
           ("final_norm", (D,), "ones", None),
           ("lm_head", (D, d["V"]), "normal", D ** -0.5)]
    if Ld:
        out += _attn("dense_blocks", Ld, d)
        out += _swiglu("dense_blocks/mlp", Ld, D, d["Fd"])
    out += _attn("blocks", Lm, d)
    out += _swiglu("blocks/shared", Lm, D, d["Fs"])
    out += [("blocks/moe/router", (Lm, D, E), "normal", D ** -0.5),
            ("blocks/moe/e_score_correction_bias", (Lm, E), "normal", 0.01),
            ("blocks/moe/wi", (Lm, E, D, 2 * F_), "normal", D ** -0.5),
            ("blocks/moe/wo", (Lm, E, F_, D), "normal", F_ ** -0.5)]
    return sorted(out)


def mla(p: dict, x, cfg: dict, prec: str):
    """Pre-normed causal MLA; returns the residual's increment."""
    d = _dims(cfg)
    B, S, D = x.shape
    H, R, dn, dr, dv = d["H"], d["R"], d["dn"], d["dr"], d["dv"]
    theta = cfg["rope_theta"]
    h = C.rmsnorm(x, p["ln_attn"], C.eps(cfg))
    q = C.mm(h, p["wq"].reshape(D, H * (dn + dr)), prec).view(B, S, H,
                                                               dn + dr)
    kv = C.mm(h, p["wkv_a"], prec)
    c = C.rmsnorm(kv[..., :R], p["kv_norm"], C.eps(cfg))
    k_r = C.rope(kv[..., None, R:], theta)
    kvb = C.mm(c, p["wkv_b"].reshape(R, H * (dn + dv)), prec).view(
        B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], C.rope(q[..., dn:], theta)], dim=-1)
    k = torch.cat([kvb[..., :dn], k_r.expand(B, S, H, dr)], dim=-1)
    o = C.causal_attention(q, k, kvb[..., dn:], prec)
    return C.mm(o.reshape(B, S, H * dv), p["wo"].reshape(H * dv, D), prec)


def route(p: dict, h, cfg: dict, prec: str):
    """h [T, D] -> (gates [T, K], experts [T, K])."""
    K = cfg["num_experts_per_tok"]
    s = torch.sigmoid(C.mm(h, p["router"], prec))
    order = torch.sort(s.detach() + p["bias"].detach(), dim=-1,
                       descending=True, stable=True).indices
    idx = order[:, :K]
    g = s.gather(-1, idx)
    if cfg["norm_topk_prob"]:
        g = g / (g.sum(-1, keepdim=True) + 1e-20)
    return g * cfg["routed_scaling_factor"], idx


def experts(p: dict, x, cfg: dict, prec: str):
    """Pre-normed routed and shared experts; returns the residual's
    increment."""
    B, S, D = x.shape
    F_ = cfg["moe_intermediate_size"]
    h = C.rmsnorm(x, p["ln_mlp"], C.eps(cfg)).reshape(B * S, D)
    gates, idx = route(p, h, cfg, prec)
    out = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        tok, choice = (idx == e).nonzero(as_tuple=True)
        if not tok.numel():
            continue
        a = C.mm(h[tok], p["wi"][e], prec)
        a = F.silu(a[:, :F_]) * a[:, F_:]
        y = C.mm(a, p["wo"][e], prec) * gates[tok, choice][:, None]
        out = out.index_add(0, tok, y)
    shared = C.mm(F.silu(C.mm(h, p["shared_wi_gate"], prec))
                  * C.mm(h, p["shared_wi_up"], prec), p["shared_wo"], prec)
    return (out + shared).view(B, S, D) + 0.0 * p["bias"].sum()


def _layer(params: dict, prefix: str, i: int) -> dict:
    n = len(prefix) + 1
    return {k[n:].replace("attn/", "").replace("/", "_"): v[i]
            for k, v in params.items() if k.startswith(prefix + "/")}


def loss(params: dict, cfg: dict, tokens, labels, prec: str,
         z_loss: float):
    """The mean loss over the positions of ``tokens [R, S]``."""
    x = C.held(params["embed"][tokens], prec)

    def dense(x, p):
        x = C.held(x + mla(p, x, cfg, prec), prec)
        return C.held(x + C.mlp_block(
            {"ln_mlp": p["ln_mlp"], "wi_gate": p["mlp_wi_gate"],
             "wi_up": p["mlp_wi_up"], "wo": p["mlp_wo"]}, x, cfg, prec),
            prec)

    def moe(x, p):
        x = C.held(x + mla(p, x, cfg, prec), prec)
        q = {"router": p["moe_router"],
             "bias": p["moe_e_score_correction_bias"], "wi": p["moe_wi"],
             "wo": p["moe_wo"], "ln_mlp": p["ln_mlp"],
             "shared_wi_gate": p["shared_wi_gate"],
             "shared_wi_up": p["shared_wi_up"], "shared_wo": p["shared_wo"]}
        return C.held(x + experts(q, x, cfg, prec), prec)
    Ld = cfg["first_k_dense_replace"]
    for i in range(Ld):
        x = C.layered(dense, x, _layer(params, "dense_blocks", i))
    for i in range(cfg["num_hidden_layers"] - Ld):
        x = C.layered(moe, x, _layer(params, "blocks", i))
    return C.logits_loss(params, x, labels, cfg, prec, z_loss)
