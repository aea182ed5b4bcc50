"""rwkv6-3b (Finch): attn-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="rwkv6-3b", family=Family.SSM,
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
)
