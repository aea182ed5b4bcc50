"""Plain PyTorch pieces of the reference: float32 throughout, with TF32
off, no kernels and no cache; each layer under activation checkpointing so
that the full-width models fit. ``prec="fp8"`` rounds both operands of
every product (the weights' and attention's) to float8 e4m3, scaled per
tensor, and their gradients to e5m2: the lower precision that the control
runs in.

``prec="fp8"`` also rounds the residual stream, which the program holds in
its compute dtype, to e4m3 after the embedding and after every block
(:func:`held`).

A model module (``dense``, ``hybrid``) gives ``layout(cfg)``, the leaves
of its parameters as ``(path, shape, init, scale)``, and ``loss(params,
cfg, tokens, labels, prec)``; :func:`train` runs the optimizer over it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2,
                                                       57344.0)}


def exact_float32() -> None:
    """Products in true float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x, kind):
    dtype, top = FP8[kind]
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, "e5m2")


def operand(x, prec: str):
    return _Fp8.apply(x) if prec == "fp8" else x


def held(x, prec: str):
    """An activation as the program holds it between blocks: in float32
    here, rounded to float8 in the control."""
    return operand(x, prec)


def mm(x, w, prec: str):
    """x [..., K] @ w [K, N]."""
    return operand(x, prec) @ operand(w, prec)


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of x [B, S, H, hd] at positions 0..S-1: the first
    and second halves of each head rotated by angles pos * theta^(-i/half)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, prec: str):
    """q [B, S, H, hd]; k, v [B, S, KV, hd], query head h reading key head
    h // (H / KV) -> [B, S, H, hd]."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, hd]
    s = operand(qt, prec) @ operand(kt, prec).transpose(-1, -2) * hd ** -0.5
    S = s.shape[-1]
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return (operand(p, prec) @ operand(vt, prec)).transpose(1, 2)


def attention_block(p, x, cfg: dict, prec: str):
    """Pre-normed GQA self-attention with RoPE; returns the residual's
    increment."""
    B, S, D = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = p["wq"].shape[-1]
    h = rmsnorm(x, p["ln_attn"], eps(cfg))
    q = mm(h, p["wq"].reshape(D, H * hd), prec).view(B, S, H, hd)
    k = mm(h, p["wk"].reshape(D, KV * hd), prec).view(B, S, KV, hd)
    v = mm(h, p["wv"].reshape(D, KV * hd), prec).view(B, S, KV, hd)
    theta = cfg["rope_theta"]
    o = causal_attention(rope(q, theta), rope(k, theta), v, prec)
    return mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, D), prec)


def mlp_block(p, x, cfg: dict, prec: str):
    """Pre-normed MLP: tanh GELU on one matrix, or a SiLU gate."""
    h = rmsnorm(x, p["ln_mlp"], eps(cfg))
    if cfg["hidden_act"] == "silu":
        a = F.silu(mm(h, p["wi_gate"], prec)) * mm(h, p["wi_up"], prec)
    else:
        a = F.gelu(mm(h, p["wi_up"], prec), approximate="tanh")
    return mm(a, p["wo"], prec)


def eps(cfg: dict) -> float:
    return cfg.get("norm_epsilon", cfg.get("rms_norm_eps"))


def layered(fn, *args):
    """``fn(*args)`` under activation checkpointing."""
    return checkpoint(fn, *args, use_reentrant=False)


def logits_loss(params, x, labels, cfg: dict, prec: str, z_loss: float):
    """Final norm, output head and the mean over positions of the
    cross-entropy plus ``z_loss`` times the squared log-normaliser."""
    def head(x):
        x = rmsnorm(x, params["final_norm"], eps(cfg))
        logits = mm(x, params["lm_head"], prec)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (lse - gold + z_loss * lse * lse).mean()
    return layered(head, x)


def train(model, cfg: dict, params: dict, batches, hp: dict, prec: str,
          initial) -> dict:
    """AdamW over ``params`` (path -> float32 tensor, updated in place),
    one step a batch of ``batches`` ((tokens, labels) [R, S] on the
    device), each row's loss a block of its own and the step's loss their
    mean. Returns each step's loss, the per-leaf norm of the first step's
    gradient after clipping, and the per-leaf norm of the parameters'
    change over all steps (``initial(path)`` gives a leaf's first value)."""
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2 = hp["beta1"], hp["beta2"]
    losses, first_grad = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        for p in params.values():
            p.requires_grad_(True)
            p.grad = None
        rows = tokens.shape[0]
        total = 0.0
        for r in range(rows):
            loss = model.loss(params, cfg, tokens[r:r + 1], labels[r:r + 1],
                              prec, hp["z_loss"])
            (loss / rows).backward()
            total += float(loss.detach()) / rows
        losses.append(total)
        with torch.no_grad():
            norms = {k: float(torch.linalg.vector_norm(
                p.grad, dtype=torch.float64)) for k, p in params.items()}
            gnorm = math.sqrt(sum(n * n for n in norms.values()))
            scale = min(1.0, hp["grad_clip"] / max(gnorm, 1e-9))
            if step == 1:
                first_grad = {k: n * scale for k, n in norms.items()}
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for k, p in params.items():
                g = p.grad.mul_(scale)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                # the step (m / c1) / (sqrt(v / c2) + eps) + wd p, in one
                # leaf-sized temporary
                d = v[k].div(c2).sqrt_().add_(hp["eps"])
                torch.div(m[k], d, out=d).div_(c1)
                p.sub_(d.add_(p, alpha=hp["weight_decay"]), alpha=hp["lr"])
                p.grad = None
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p - initial(k),
                                                    dtype=torch.float64))
                  for k, p in params.items()}
    return {"losses": losses, "grad": first_grad, "change": change}
