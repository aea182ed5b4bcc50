"""deepseek-67b: dense GQA, llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="deepseek-67b", family=Family.DENSE,
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, head_dim=128, rope_theta=1e4,
)
