"""Model configurations of the port that the JAX package does not have.

``config.py`` and ``configs/*.py`` are copies of the JAX package's and stay
so; a model whose architecture needs fields the shared ``ModelConfig``
lacks gets a frozen subclass here and a preset in :data:`PRESETS`.
:func:`get_config` and :func:`arch_ids` are the launchers' lookup: these
presets first, then the shared ones.

:class:`MlaMoeConfig` is the DeepSeek-V3 layout (``model_type``
``deepseek_v3``; arXiv:2412.19437 §2.1, arXiv:2405.04434 §2.1): latent
attention (MLA) with ``q_lora_rank`` null, ``first_k_dense`` dense SwiGLU
layers of ``dense_d_ff``, then MoE layers of ``n_experts`` routed SwiGLU
experts of ``d_ff`` (``top_k`` a token, chosen by sigmoid scores plus a
selection bias, weighted by the scores, normalised and scaled by
``routed_scaling``) beside ``n_shared_experts`` shared ones, computed as
one SwiGLU of ``n_shared_experts * d_ff``. The routing is dropless:
``capacity_factor`` is unused.

A plain ``ModelConfig`` whose ``arch_id`` names a preset here (a
configuration file that can only carry the shared fields) takes the
preset's own fields through :func:`resolve`, where it enters the program:
``registry.get_api`` and ``train.steps.make_train_step``. The models see
the preset's class only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

from repro_torch import configs
from repro_torch.config import Family, ModelConfig


@dataclass(frozen=True)
class MlaMoeConfig(ModelConfig):
    # --- latent attention (MLA), q_lora_rank null ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- layers and experts ---
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_d_ff: int = 0
    routed_scaling: float = 1.0
    rms_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense

    @property
    def shared_d_ff(self) -> int:
        return self.n_shared_experts * self.d_ff

    def reduced(self) -> "MlaMoeConfig":
        """CPU smoke-test config: two layers (the dense one and an MoE
        one), narrow widths but the attention's head dims (the kernels'
        pair), 8 experts of which 3 a token."""
        return replace(
            self, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
            d_ff=64, vocab_size=512, n_experts=8, top_k=3, kv_lora_rank=64,
            n_shared_experts=min(self.n_shared_experts, 2),
            first_k_dense=min(self.first_k_dense, 1), dense_d_ff=256,
            remat="none")

    # ---- analytic parameter count -------------------------------------------
    def _attn_params(self) -> int:
        D, H, R = self.d_model, self.n_heads, self.kv_lora_rank
        return (D * H * self.qk_head_dim                       # wq
                + D * (R + self.qk_rope_head_dim) + R           # wkv_a, norm
                + R * H * (self.qk_nope_head_dim + self.v_head_dim)
                + H * self.v_head_dim * D)                      # wo

    def _moe_params(self, experts: int) -> int:
        D, E = self.d_model, self.n_experts
        return (D * E + E                                       # router, bias
                + experts * 3 * D * self.d_ff
                + 3 * D * self.shared_d_ff)

    def param_count(self) -> int:
        D = self.d_model
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        per = self._attn_params() + 2 * D
        dense = self.first_k_dense * (per + 3 * D * self.dense_d_ff)
        moe = self.n_moe_layers * (per + self._moe_params(self.n_experts))
        return emb + dense + moe + D

    def active_param_count(self) -> int:
        """:meth:`param_count` with ``top_k`` of the routed experts."""
        return self.param_count() - self.n_moe_layers * (
            self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff


MOONLIGHT = MlaMoeConfig(
    # hf:moonshotai/Moonlight-16B-A3B config.json (model_type deepseek_v3)
    arch_id="moonlight-16b-a3b", family=Family.MOE,
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab_size=163840, rope_theta=5e4,
    n_experts=64, top_k=6, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_shared_experts=2,
    first_k_dense=1, dense_d_ff=11264, routed_scaling=2.446, rms_eps=1e-5,
)

PRESETS = {MOONLIGHT.arch_id: MOONLIGHT}
_BASE_FIELDS = tuple(f.name for f in dataclasses.fields(ModelConfig))


def get_config(arch_id: str) -> ModelConfig:
    """The preset ``arch_id``: this module's, else ``configs.get_config``'s."""
    if arch_id in PRESETS:
        return PRESETS[arch_id]
    return configs.get_config(arch_id)


def arch_ids() -> list:
    """Every arch the launchers take: the shared ones, then this module's."""
    return configs.all_arch_ids() + list(PRESETS)


def resolve(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with its preset's own fields where it is a plain
    ``ModelConfig`` whose ``arch_id`` names a preset here (its shared
    fields kept as given: a cut depth, say); else ``cfg`` itself."""
    if type(cfg) is not ModelConfig or cfg.arch_id not in PRESETS:
        return cfg
    return replace(PRESETS[cfg.arch_id],
                   **{k: getattr(cfg, k) for k in _BASE_FIELDS})


def is_mla(cfg: ModelConfig) -> bool:
    return isinstance(cfg, MlaMoeConfig)
