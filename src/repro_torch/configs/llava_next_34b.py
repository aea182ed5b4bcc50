"""llava-next-34b backbone: anyres patch frontend STUBBED; input_specs
provides precomputed patch embeddings [hf:llava-hf; unverified]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="llava-next-34b", family=Family.VLM,
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128, rope_theta=5e6,
    n_patch_tokens=2880,   # anyres 5 tiles x 576 patches (precomputed stub)
)
