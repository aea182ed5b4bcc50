"""starcoder2-7b: dense GQA, RoPE, 2-matrix GELU MLP [arXiv:2402.19173; hf]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="starcoder2-7b", family=Family.DENSE,
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128, rope_theta=1e5,
    mlp_kind="gelu",
)
