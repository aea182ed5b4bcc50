"""Config system: model architecture + input-shape + runtime configs.

Every assigned architecture is a ModelConfig in repro/configs/<id>.py with
the exact published numbers; reduced() derives the CPU smoke-test config.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Optional


class Family(str, Enum):
    DENSE = "dense"
    MOE = "moe"
    HYBRID = "hybrid"     # mamba2 + shared attention (zamba2)
    SSM = "ssm"           # rwkv6
    ENCDEC = "encdec"     # seamless
    VLM = "vlm"           # llava-next


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // n_heads
    qkv_bias: bool = False                # qwen2
    mlp_kind: str = "swiglu"              # swiglu (3 mats) | gelu (2 mats)
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False          # arctic: dense MLP in parallel w/ MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_period: int = 0           # zamba2: shared attn every N layers
    # --- enc-dec ---
    n_enc_layers: int = 0
    # --- dtypes / training ---
    params_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                   # none | full | dots
    # --- modality stub widths (vlm/audio input_specs) ---
    n_patch_tokens: int = 0               # llava: precomputed patch embeds
    n_frame_tokens: int = 0               # seamless: precomputed frames
    # --- serving ---
    kv_cache_dtype: str = "bfloat16"      # int8: quantized KV cache (serving)
    # --- kernels ---
    use_pallas: bool = False              # TPU path; CPU uses XLA reference

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the vocab dim shards
        evenly (logits at long seq otherwise replicate). Ids >= vocab_size
        are never emitted by data/labels; lm_head rows for them are dead."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:             # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test config of the same family."""
        return replace(
            self,
            n_layers=min(self.n_layers, 4 if self.shared_attn_period else 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            shared_attn_period=2 if self.shared_attn_period else 0,
            n_patch_tokens=8 if self.n_patch_tokens else 0,
            n_frame_tokens=16 if self.n_frame_tokens else 0,
            remat="none",
        )

    # ---- analytic parameter count (checked by tests) -------------------------
    def param_count(self) -> int:
        D, H, KV, hd, F, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.hd, self.d_ff, self.vocab_size)
        def attn(bias: bool) -> int:
            n = D * H * hd + 2 * D * KV * hd + H * hd * D
            if bias:
                n += H * hd + 2 * KV * hd
            return n
        def mlp(f: int) -> int:
            return (3 if self.mlp_kind == "swiglu" else 2) * D * f
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        if self.family in (Family.DENSE, Family.VLM):
            per = attn(self.qkv_bias) + mlp(F) + 2 * D
            return self.n_layers * per + emb + D
        if self.family == Family.MOE:
            per = attn(self.qkv_bias) + 2 * D + D * self.n_experts \
                + self.n_experts * mlp(F)
            if self.dense_residual:
                per += mlp(F)
            return self.n_layers * per + emb + D
        if self.family == Family.SSM:  # rwkv6
            per = self._rwkv6_layer_params()
            return self.n_layers * per + emb + D
        if self.family == Family.HYBRID:
            per = self._mamba2_layer_params()
            shared = attn(False) + mlp(F) + 2 * D
            return self.n_layers * per + shared + emb + D
        if self.family == Family.ENCDEC:
            enc = self.n_enc_layers * (attn(False) + mlp(F) + 2 * D)
            dec = self.n_layers * (2 * attn(False) + mlp(F) + 3 * D)
            return enc + dec + emb + 2 * D   # enc_norm + final_norm
        raise ValueError(self.family)

    def _mamba2_layer_params(self) -> int:
        D, Din, S = self.d_model, self.d_inner, self.ssm_state
        nh = self.ssm_heads
        in_proj = D * (2 * Din + 2 * S + nh)       # x, z, B, C, dt
        conv = self.ssm_conv * (Din + 2 * S)
        out = Din * D
        extras = 3 * nh + Din                      # A_log, D, dt_bias, norm
        return in_proj + conv + out + extras + D   # + rmsnorm

    def _rwkv6_layer_params(self) -> int:
        D, F = self.d_model, self.d_ff
        lora_w, lora_mix = 64, 32                  # matches models.rwkv6
        tm = (D                                    # mix_base
              + D * lora_mix + 5 * lora_mix * D    # ddlerp lora A/B
              + 5 * D                              # mix_mu
              + D + D * lora_w + lora_w * D        # decay base + lora
              + D                                  # bonus u
              + 5 * D * D                          # wr wk wv wg wo
              + D)                                 # ln_x
        cm = 2 * D + D * F + F * D + D * D         # mu_k, mu_r, wk, wv, wr
        ln = 2 * D                                 # ln1, ln2
        return tm + cm + ln

    def active_param_count(self) -> int:
        """6*N_active*D basis for MODEL_FLOPS (MoE: top_k of n_experts)."""
        if self.family != Family.MOE:
            return self.param_count()
        full = self.param_count()
        expert = 3 * self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return full - inactive


class ShapeKind(str, Enum):
    TRAIN = "train"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: ShapeKind


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, ShapeKind.TRAIN),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, ShapeKind.PREFILL),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, ShapeKind.DECODE),
    "long_500k": ShapeConfig("long_500k", 524288, 1, ShapeKind.DECODE),
}

# long_500k needs sub-quadratic sequence mixing: SSM / hybrid only.
LONG_CONTEXT_FAMILIES = {Family.SSM, Family.HYBRID}


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.family in LONG_CONTEXT_FAMILIES:
        out.append(SHAPES["long_500k"])
    return out


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1                  # gradient accumulation
    grad_compression: str = "none"         # none | bf16 | int8_ef
    z_loss: float = 1e-4
    seed: int = 0
