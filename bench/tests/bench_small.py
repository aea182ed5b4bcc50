"""Small stand-ins of the benchmark's configurations and mix for the CPU
tests: every width cut down, the structure kept."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


SMALL = {
    "dense": {"hidden_size": 128, "intermediate_size": 256,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 32, "num_hidden_layers": 2, "vocab_size": 512},
    "hybrid": {"hidden_size": 128, "intermediate_size": 256,
               "num_attention_heads": 4, "num_key_value_heads": 4,
               "kv_channels": 32, "num_hidden_layers": 4,
               "shared_attn_period": 2, "vocab_size": 512,
               "mamba_d_state": 16, "mamba_headdim": 32, "n_mamba_heads": 8},
}
PORT = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
        "head_dim": "head_dim", "kv_channels": "head_dim",
        "num_hidden_layers": "n_layers", "vocab_size": "vocab_size",
        "shared_attn_period": "shared_attn_period",
        "mamba_d_state": "ssm_state", "mamba_headdim": "ssm_head_dim"}


def small_config(name: str, compute_dtype: str = "float32") -> dict:
    """The configuration file ``name`` with the small widths, in the file's
    keys and in its ``port_config`` alike."""
    cfg = load("configs", name)
    cut = SMALL[cfg["family"]]
    cfg.update(cut)
    pc = dict(cfg["port_config"])
    for k, v in cut.items():
        if k in PORT:
            pc[PORT[k]] = v
    pc["compute_dtype"] = compute_dtype
    cfg["port_config"] = pc
    return cfg


def small_mix(name: str = "train_4k") -> dict:
    mix = load("traffic", name)
    mix.update(seq_len=64, shard_tokens=20000)
    mix["documents"] = dict(mix["documents"], median=16, max=256)
    return mix
