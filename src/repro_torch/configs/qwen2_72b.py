"""qwen2-72b: dense GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="qwen2-72b", family=Family.DENSE,
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)
