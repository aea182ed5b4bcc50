"""The yardstick: the card's peaks, parameter counts from a configuration
file's widths, a training step's model FLOPs, and the least time a kernel's
call needs at its shapes.

Everything here reads the configuration file (``bench/configs/*.json``)
and never the program's own config objects, so that a change to the
program cannot move it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16, F32 = 2, 4          # bytes an element


def _attn_params(c: dict) -> int:
    D, H, KV, hd = (c["hidden_size"], c["num_attention_heads"],
                    c["num_key_value_heads"], head_dim(c))
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def _mlp_params(c: dict) -> int:
    mats = 3 if c["hidden_act"] == "silu" else 2     # gated or not
    return mats * c["hidden_size"] * c["intermediate_size"]


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c.get("kv_channels") \
        or c["hidden_size"] // c["num_attention_heads"]


def embedding_params(c: dict) -> int:
    """The embedding table and, untied, the output head."""
    tables = 1 if c.get("tie_word_embeddings") else 2
    return tables * c["vocab_size"] * c["hidden_size"]


def mamba_layer_params(c: dict) -> int:
    D = c["hidden_size"]
    Din = c["mamba_expand"] * D
    N = c["mamba_ngroups"] * c["mamba_d_state"]
    nh = c["n_mamba_heads"]
    in_proj = D * (2 * Din + 2 * N + nh)          # z, x, B, C, dt
    conv = c["mamba_d_conv"] * (Din + 2 * N)
    out = Din * D
    extras = 3 * nh + Din                         # A_log, D, dt_bias, norm
    return in_proj + conv + out + extras + D      # + the block's norm


def param_count(c: dict) -> int:
    """Parameters of the configuration as run."""
    D = c["hidden_size"]
    if c["family"] == "dense":
        per = _attn_params(c) + _mlp_params(c) + 2 * D
        return c["num_hidden_layers"] * per + embedding_params(c) + D
    if c["family"] == "hybrid":
        shared = c["num_mem_blocks"] * (_attn_params(c) + _mlp_params(c)
                                        + 2 * D)
        return (c["num_hidden_layers"] * mamba_layer_params(c) + shared
                + embedding_params(c) + D)
    raise ValueError(f"no parameter count for family {c['family']!r}")


def attention_layers(c: dict) -> int:
    """The attention layers one token passes."""
    if c["family"] == "hybrid":
        return c["num_hidden_layers"] // c["shared_attn_period"]
    return c["num_hidden_layers"]


def ssd_forward_flops(c: dict, rows: int, seq: int) -> float:
    """One forward of the chunked SSD scan over all heads of one layer:
    2c(cN + cP + 2NP) a head and chunk of c positions."""
    ch = min(64, seq)
    n, p = c["mamba_d_state"], c["mamba_headdim"]
    return 2.0 * ch * (ch * n + ch * p + 2 * n * p) * c["n_mamba_heads"] \
        * (seq // ch) * rows


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows of ``seq``
    tokens: 6 a non-embedding parameter and token, causal attention forward
    and backward (6 H hd S^2 a row and attention layer), and a hybrid's SSD
    scan (three times its forward). Recomputed work is not counted."""
    embed = c["vocab_size"] * c["hidden_size"]     # a gather, no products
    out = 6.0 * (param_count(c) - embed) * rows * seq
    out += 6.0 * attention_layers(c) * c["num_attention_heads"] \
        * head_dim(c) * seq * seq * rows
    if c["family"] == "hybrid":
        out += 3.0 * ssd_forward_flops(c, rows, seq) * c["num_hidden_layers"]
    return out


def least_s(flops: float, nbytes: float) -> float:
    """The least time of a call: its operations at the bf16 peak or its
    bytes, each read once and written once, at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_attention_least_s(c: dict, rows: int, seq: int) -> tuple:
    """(forward, backward) least seconds of one causal attention call over
    ``rows`` rows of ``seq`` positions. The forward makes 2 products over
    the S(S+1)/2 kept pairs, reads q, k, v and writes o, its f32 copy and
    the log-sum-exp; the backward makes 5 (the scores again, dP, dV, dQ,
    dK), reads q, k, v, the f32 o, lse and do and writes dq, dk, dv."""
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], \
        head_dim(c)
    pairs = seq * (seq + 1) / 2
    q = rows * seq * H * hd
    kv = rows * seq * KV * hd
    lse = rows * H * seq
    fwd = least_s(4.0 * rows * H * hd * pairs,
                  (q + 2 * kv) * BF16 + q * (BF16 + F32) + lse * F32)
    bwd = least_s(10.0 * rows * H * hd * pairs,
                  (2 * q + 2 * kv) * BF16 + q * F32 + lse * F32
                  + (q + 2 * kv) * BF16)
    return fwd, bwd


def mamba2_ssd_least_s(c: dict, rows: int, seq: int) -> tuple:
    """(forward, backward) least seconds of one SSD scan call of one layer:
    operations as :func:`model_flops` counts them (the backward twice the
    forward); the forward reads x (bf16), dt, A, B, C (f32) and writes y
    (bf16) and the final state (f32), the backward reads those inputs and
    dy and writes dx (bf16), ddt, dA, dB, dC (f32)."""
    H, P, N = c["n_mamba_heads"], c["mamba_headdim"], c["mamba_d_state"]
    x = rows * seq * H * P
    dt = rows * seq * H
    bc = 2 * rows * seq * N
    state = rows * H * N * P
    ops = ssd_forward_flops(c, rows, seq)
    fwd = least_s(ops, x * BF16 + (dt + H + bc) * F32 + x * BF16
                  + state * F32)
    bwd = least_s(2 * ops, 2 * x * BF16 + (dt + H + bc) * F32 + x * BF16
                  + (dt + H + bc) * F32)
    return fwd, bwd
