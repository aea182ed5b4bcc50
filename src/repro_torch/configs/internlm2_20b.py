"""internlm2-20b: dense GQA [arXiv:2403.17297; hf]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="internlm2-20b", family=Family.DENSE,
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128, rope_theta=1e6,
)
