"""seamless-m4t-medium: enc-dec multimodal backbone; audio frontend STUBBED
(input_specs provides precomputed frame embeddings) [arXiv:2308.11596; hf]."""
from repro_torch.config import ModelConfig, Family

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium", family=Family.ENCDEC,
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64, rope_theta=1e4,
    n_frame_tokens=4096, mlp_kind="gelu",
)
