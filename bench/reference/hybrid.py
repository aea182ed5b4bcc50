"""Plain reference of the zamba2-style hybrid as the configuration runs it
(``family: hybrid``): token embedding, Mamba2 blocks (pre-norm, one input
projection split into the gate z, the conv's input (x, B, C) and dt, a
depthwise causal conv without bias and SiLU, the SSD scan with a skip D,
a gated RMSNorm and the output projection), and after every
``shared_attn_period`` of them one shared attention + SwiGLU block with
the same weights each time; a final RMSNorm and an untied output head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import common as C


def layout(cfg: dict) -> list:
    """The parameter leaves ``(path, shape, init, scale)``. The Mamba2
    leaves take mamba_ssm's usual draws: A_log = log U(1, 16), dt_bias the
    inverse softplus of a step log-uniform on [1e-3, 0.1] (floor 1e-4),
    and the output projection scaled by 1/sqrt(layers)
    (``rescale_prenorm_residual``)."""
    L, D, Fw = (cfg["num_hidden_layers"], cfg["hidden_size"],
                cfg["intermediate_size"])
    H, KV, hd, V = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                    cfg["kv_channels"], cfg["vocab_size"])
    Din = cfg["mamba_expand"] * D
    N = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    nh, k = cfg["n_mamba_heads"], cfg["mamba_d_conv"]
    return sorted([
        ("embed", (V, D), "normal", 1.0),
        ("blocks/ln", (L, D), "ones", None),
        ("blocks/mamba/in_proj", (L, D, 2 * Din + 2 * N + nh), "normal",
         D ** -0.5),
        ("blocks/mamba/conv_w", (L, k, Din + 2 * N), "normal", 0.5),
        ("blocks/mamba/A_log", (L, nh), "log_uniform", (1.0, 16.0)),
        ("blocks/mamba/D", (L, nh), "ones", None),
        ("blocks/mamba/dt_bias", (L, nh), "dt_bias", (1e-3, 0.1, 1e-4)),
        ("blocks/mamba/norm", (L, Din), "ones", None),
        ("blocks/mamba/out_proj", (L, Din, D), "normal",
         (Din * L) ** -0.5),
        ("shared/attn/wq", (D, H, hd), "normal", D ** -0.5),
        ("shared/attn/wk", (D, KV, hd), "normal", D ** -0.5),
        ("shared/attn/wv", (D, KV, hd), "normal", D ** -0.5),
        ("shared/attn/wo", (H, hd, D), "normal", (H * hd) ** -0.5),
        ("shared/ln_attn", (D,), "ones", None),
        ("shared/ln_mlp", (D,), "ones", None),
        ("shared/mlp/wi_gate", (D, Fw), "normal", D ** -0.5),
        ("shared/mlp/wi_up", (D, Fw), "normal", D ** -0.5),
        ("shared/mlp/wo", (Fw, D), "normal", Fw ** -0.5),
        ("final_norm", (D,), "ones", None),
        ("lm_head", (D, V), "normal", D ** -0.5),
    ])


def ssd(x, dt, A, B, Cm, chunk: int = 64):
    """The SSD recurrence s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t^T, y_t =
    C_t s_t from a zero state, per head, computed in chunks: a masked
    quadratic form inside a chunk, the states carried between chunks.
    x [b, l, h, p], dt [b, l, h], A [h], B, Cm [b, l, n] -> y [b, l, h, p]."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    c = min(chunk, l)
    z = l // c
    x = x.reshape(b, z, c, h, p)
    dt = dt.reshape(b, z, c, h)
    B = B.reshape(b, z, c, n)
    Cm = Cm.reshape(b, z, c, n)
    cs = torch.cumsum(dt * A, dim=2)                          # [b,z,c,h]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # [b,z,i,j,h]
    keep = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~keep[None, None, :, :, None],
                                      float("-inf")))
    w = torch.einsum("bzin,bzjn->bzij", Cm, B)[..., None] * decay
    xdt = x * dt[..., None]
    y = torch.einsum("bzijh,bzjhp->bzihp", w, xdt)
    to_end = torch.exp(cs[:, :, -1:, :] - cs)                 # [b,z,c,h]
    states = torch.einsum("bzcn,bzchp->bzhnp", B, xdt * to_end[..., None])
    carry = x.new_zeros(b, h, n, p)
    before = []
    for i in range(z):
        before.append(carry)
        carry = carry * torch.exp(cs[:, i, -1, :])[..., None, None] \
            + states[:, i]
    before = torch.stack(before, dim=1)                       # [b,z,h,n,p]
    y = y + torch.einsum("bzcn,bzch,bzhnp->bzchp", Cm, torch.exp(cs),
                         before)
    return y.reshape(b, l, h, p)


def mamba_block(p: dict, x, cfg: dict, prec: str):
    D = cfg["hidden_size"]
    Din = cfg["mamba_expand"] * D
    N = cfg["mamba_ngroups"] * cfg["mamba_d_state"]
    nh, hp, k = cfg["n_mamba_heads"], cfg["mamba_headdim"], \
        cfg["mamba_d_conv"]
    eps = C.eps(cfg)
    h = C.rmsnorm(x, p["ln"], eps)
    z, xbc, dt = torch.split(C.mm(h, p["in_proj"], prec), [Din, Din + 2 * N,
                                                           nh], dim=-1)
    Lx = x.shape[1]
    hist = F.pad(xbc, (0, 0, k - 1, 0))
    conv = F.silu(sum(hist[:, i:i + Lx] * p["conv_w"][i] for i in range(k)))
    xs, B, Cm = torch.split(conv, [Din, N, N], dim=-1)
    xs = xs.reshape(*xs.shape[:-1], nh, hp)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = ssd(xs, dt, A, B, Cm) + xs * p["D"][:, None]
    y = C.rmsnorm(y.reshape(*y.shape[:-2], Din) * F.silu(z), p["norm"], eps)
    return x + C.mm(y, p["out_proj"], prec)


def loss(params: dict, cfg: dict, tokens, labels, prec: str,
         z_loss: float):
    """The mean loss over the positions of ``tokens [R, S]``."""
    x = C.held(params["embed"][tokens], prec)
    shared = {"wq": params["shared/attn/wq"], "wk": params["shared/attn/wk"],
              "wv": params["shared/attn/wv"], "wo": params["shared/attn/wo"],
              "ln_attn": params["shared/ln_attn"]}
    mlp = {"ln_mlp": params["shared/ln_mlp"],
           "wi_gate": params["shared/mlp/wi_gate"],
           "wi_up": params["shared/mlp/wi_up"], "wo": params["shared/mlp/wo"]}

    def mamba(x, p):
        return C.held(mamba_block(p, x, cfg, prec), prec)

    def shared_block(x, pa, pm):
        x = C.held(x + C.attention_block(pa, x, cfg, prec), prec)
        return C.held(x + C.mlp_block(pm, x, cfg, prec), prec)

    period = cfg["shared_attn_period"]
    for i in range(cfg["num_hidden_layers"]):
        layer = {name.split("/")[-1]: params[name][i] for name in params
                 if name.startswith("blocks/")}
        x = C.layered(mamba, x, layer)
        if (i + 1) % period == 0:
            x = C.layered(shared_block, x, shared, mlp)
    return C.logits_loss(params, x, labels, cfg, prec, z_loss)
