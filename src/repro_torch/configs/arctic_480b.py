"""arctic-480b: MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="arctic-480b", family=Family.MOE,
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128, rope_theta=1e6,
    n_experts=128, top_k=2, dense_residual=True,
)
