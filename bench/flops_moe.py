"""The yardstick of the DeepSeek-V3 layout (``family: moe``): parameter
counts, a training step's model FLOPs, and the least time of a call of
latent attention's K3 (query/key and value head dims apart) and of the
dropless experts' grouped products (K6/K6b) at their shapes.

Everything here reads the configuration file (``bench/configs/*.json``,
the keys of the published ``config.json``) and never the program's own
config objects, so that a change to the program cannot move it. Peaks
and the least-time rule are ``bench.flops``'."""
from __future__ import annotations

from bench.flops import BF16, F32, least_s


def _dims(c: dict) -> dict:
    F_ = c["moe_intermediate_size"]
    return {"L": c["num_hidden_layers"], "Ld": c["first_k_dense_replace"],
            "D": c["hidden_size"], "H": c["num_attention_heads"],
            "R": c["kv_lora_rank"], "dn": c["qk_nope_head_dim"],
            "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "E": c["n_routed_experts"], "K": c["num_experts_per_tok"],
            "F": F_, "Fs": c["n_shared_experts"] * F_,
            "Fd": c["intermediate_size"], "V": c["vocab_size"]}


def attention_params(c: dict) -> int:
    """MLA with ``q_lora_rank`` null: W_q, W_kva, the latent's norm, W_kvb
    and W_o."""
    d = _dims(c)
    D, H, R, dn, dr, dv = (d[k] for k in ("D", "H", "R", "dn", "dr", "dv"))
    return D * H * (dn + dr) + D * (R + dr) + R + R * H * (dn + dv) \
        + H * dv * D


def _routed(c: dict, experts: int) -> int:
    d = _dims(c)
    return experts * 3 * d["D"] * d["F"]


def param_count(c: dict) -> int:
    """Parameters of the configuration as run: the embedding and the head,
    the leading dense layers, the MoE layers (router, selection bias, the
    routed and the shared experts) and the final norm."""
    d = _dims(c)
    D, E = d["D"], d["E"]
    tables = 1 if c.get("tie_word_embeddings") else 2
    layer = attention_params(c) + 2 * D
    dense = d["Ld"] * (layer + 3 * D * d["Fd"])
    moe = (d["L"] - d["Ld"]) * (layer + D * E + E + _routed(c, E)
                                + 3 * D * d["Fs"])
    return tables * d["V"] * D + dense + moe + D


def active_param_count(c: dict) -> int:
    """:func:`param_count` with ``num_experts_per_tok`` of the routed
    experts."""
    d = _dims(c)
    return param_count(c) - (d["L"] - d["Ld"]) * _routed(c, d["E"] - d["K"])


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one training step over ``rows`` rows of ``seq``
    tokens: 6 an active non-embedding parameter and token (the head
    counted, ``num_experts_per_tok`` routed experts) and causal attention
    forward and backward, 3 (dqk + dv) H S^2 a row and layer. Recomputed
    work and the routing's padding are not counted."""
    d = _dims(c)
    embed = d["V"] * d["D"]                     # a gather, no products
    out = 6.0 * (active_param_count(c) - embed) * rows * seq
    out += 3.0 * (d["dn"] + d["dr"] + d["dv"]) * d["H"] * seq * seq \
        * rows * d["L"]
    return out


def mla_attention_least_s(c: dict, rows: int, seq: int) -> tuple:
    """(forward, backward) least seconds of one causal attention call over
    ``rows`` rows of ``seq`` positions, at a query/key head dim dqk and a
    value head dim dv. The forward makes 2 (dqk + dv) H operations a kept
    pair (scores, then the weighted values), reads q, k, v and writes o,
    its f32 copy and the log-sum-exp; the backward makes (6 dqk + 4 dv) H
    (the scores again, dP, dV, dQ, dK), reads q, k, v, the f32 o, lse and
    do and writes dq, dk, dv. At dqk = dv they are
    ``bench.flops.flash_attention_least_s``'s 4 and 10 hd H."""
    d = _dims(c)
    H, dqk, dv = d["H"], d["dn"] + d["dr"], d["dv"]
    pairs = seq * (seq + 1) / 2
    tok = rows * seq * H
    lse = rows * H * seq
    q, k, v = tok * dqk, tok * dqk, tok * dv
    fwd = least_s(2.0 * (dqk + dv) * H * rows * pairs,
                  (q + k + v) * BF16 + v * (BF16 + F32) + lse * F32)
    bwd = least_s((6.0 * dqk + 4.0 * dv) * H * rows * pairs,
                  (q + k + 2 * v) * BF16 + v * F32 + lse * F32
                  + (q + k + v) * BF16)
    return fwd, bwd


def moe_gmm_least_s(c: dict, rows: int, seq: int) -> tuple:
    """(forward, backward) least seconds of one MoE layer's expert
    products over the *routed* rows of ``rows`` rows of ``seq`` tokens (R =
    rows seq ``num_experts_per_tok``; a padded table's extra rows are
    waste, not work): forward D -> 2F (gate and up) and F -> D, 6 R D F
    operations, reading the rows and both weights of all experts and
    writing each product's output; backward twice the operations, reading
    the rows, the gradients and the weights and writing dx and dw."""
    d = _dims(c)
    D, F_, E = d["D"], d["F"], d["E"]
    R = rows * seq * d["K"]
    ops = 6.0 * R * D * F_
    w = E * D * 3 * F_
    fwd = least_s(ops, (R * D + R * 2 * F_ + R * F_ + R * D + w) * BF16)
    bwd = least_s(2 * ops, (2 * (R * D + R * 2 * F_ + R * F_ + R * D)
                            + 2 * w) * BF16)
    return fwd, bwd
