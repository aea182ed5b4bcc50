"""Plain reference of the dense decoder as the configuration runs it
(``family: dense``): token embedding, layers of pre-normed GQA attention
with RoPE and a pre-normed MLP, a final RMSNorm and an untied output
head, logits in float32."""
from __future__ import annotations

from bench.reference import common as C


def layout(cfg: dict) -> list:
    """The parameter leaves ``(path, shape, init, scale)``; a normal leaf
    has the standard deviation ``scale`` (one over the root of a layer's
    fan-in, 1 for the embedding)."""
    L, D, F = (cfg["num_hidden_layers"], cfg["hidden_size"],
               cfg["intermediate_size"])
    H, KV, hd, V = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                    cfg["head_dim"], cfg["vocab_size"])
    out = [("embed", (V, D), "normal", 1.0),
           ("blocks/attn/wq", (L, D, H, hd), "normal", D ** -0.5),
           ("blocks/attn/wk", (L, D, KV, hd), "normal", D ** -0.5),
           ("blocks/attn/wv", (L, D, KV, hd), "normal", D ** -0.5),
           ("blocks/attn/wo", (L, H, hd, D), "normal", (H * hd) ** -0.5),
           ("blocks/ln_attn", (L, D), "ones", None),
           ("blocks/ln_mlp", (L, D), "ones", None),
           ("blocks/mlp/wi_up", (L, D, F), "normal", D ** -0.5),
           ("blocks/mlp/wo", (L, F, D), "normal", F ** -0.5),
           ("final_norm", (D,), "ones", None),
           ("lm_head", (D, V), "normal", D ** -0.5)]
    if cfg["hidden_act"] == "silu":
        out.append(("blocks/mlp/wi_gate", (L, D, F), "normal", D ** -0.5))
    return sorted(out)


def _layer(params: dict, i: int) -> dict:
    return {"wq": params["blocks/attn/wq"][i], "wk": params["blocks/attn/wk"][i],
            "wv": params["blocks/attn/wv"][i], "wo": params["blocks/attn/wo"][i],
            "ln_attn": params["blocks/ln_attn"][i],
            "ln_mlp": params["blocks/ln_mlp"][i],
            "wi_up": params["blocks/mlp/wi_up"][i],
            "wi_gate": (params["blocks/mlp/wi_gate"][i]
                        if "blocks/mlp/wi_gate" in params else None),
            "mlp_wo": params["blocks/mlp/wo"][i]}


def loss(params: dict, cfg: dict, tokens, labels, prec: str,
         z_loss: float):
    """The mean loss over the positions of ``tokens [R, S]``."""
    x = C.held(params["embed"][tokens], prec)

    def block(x, p):
        x = C.held(x + C.attention_block(p, x, cfg, prec), prec)
        return C.held(x + C.mlp_block(
            {"ln_mlp": p["ln_mlp"], "wi_up": p["wi_up"],
             "wi_gate": p["wi_gate"], "wo": p["mlp_wo"]}, x, cfg, prec), prec)
    for i in range(cfg["num_hidden_layers"]):
        x = C.layered(block, x, _layer(params, i))
    return C.logits_loss(params, x, labels, cfg, prec, z_loss)
