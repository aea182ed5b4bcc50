"""moonshot-v1-16b-a3b (kimi/moonlight): MoE 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b", family=Family.MOE,
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128, rope_theta=5e4,
    n_experts=64, top_k=6,
)
