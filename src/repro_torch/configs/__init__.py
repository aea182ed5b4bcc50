"""Assigned-architecture configs (--arch <id>). Exact published numbers."""
from importlib import import_module

ARCHS = {
    "qwen2-72b": "qwen2_72b",
    "internlm2-20b": "internlm2_20b",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-7b": "starcoder2_7b",
    "llava-next-34b": "llava_next_34b",
    "zamba2-2.7b": "zamba2_2p7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return import_module(f"repro_torch.configs.{ARCHS[arch_id]}").CONFIG


def all_arch_ids():
    return list(ARCHS)
