"""zamba2-2.7b: Mamba2 stack + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family=Family.HYBRID,
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    shared_attn_period=6,
)
