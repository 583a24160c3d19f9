"""Architecture configuration dataclasses.

Every assigned architecture gets one module in this package exporting
``CONFIG: ModelConfig``.  The registry in ``repro_torch.configs`` resolves
``--arch <id>`` strings to these objects and can produce reduced "smoke"
variants for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    router_aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Covers both Mamba-style (hymba) and xLSTM-style recurrent blocks."""
    state_size: int = 16
    conv_width: int = 4
    expand: int = 2
    # xLSTM specifics
    num_heads: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    mlp_type: str = "swiglu"          # swiglu | relu2 | gelu | none
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm | nonparametric
    # --- attention features ---
    rope_theta: float = 10000.0
    pos_embedding: str = "rope"       # rope | learned | sinusoidal | none
    qk_norm: bool = False             # qwen3-style per-head RMS q/k norm
    use_mrope: bool = False           # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, ...] = ()   # splits of head_dim//2
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    # layer pattern, cycled over layers. entries:
    #   "attn"   - full attention block
    #   "local"  - sliding-window attention block
    #   "hymba"  - parallel attention + mamba block
    #   "slstm" / "mlstm" - xLSTM blocks
    layer_pattern: Tuple[str, ...] = ("attn",)
    # --- subsystems ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0          # stub frontend output length
    # --- vlm ---
    num_vision_tokens: int = 0        # stub frontend patch-embedding count
    # --- misc ---
    scale_embedding: bool = False     # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # long-context policy: can this arch serve 500k decode sub-quadratically?
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (excludes tiny norm params where noted)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_attn = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
        if self.mlp_type in ("swiglu", "gelu_glu"):
            n_mlp = 3 * d * self.d_ff
        elif self.mlp_type in ("relu2", "gelu"):
            n_mlp = 2 * d * self.d_ff
        else:
            n_mlp = 0
        per_layer = 0.0
        for i in range(self.num_layers):
            kind = self.pattern_for_layer(i)
            if kind in ("attn", "local"):
                per_layer += n_attn + self._layer_mlp_params(n_mlp)
            elif kind == "hymba":
                inner = (self.ssm.expand if self.ssm else 2) * d
                n_ssm = d * 2 * inner + inner * (self.ssm.state_size if self.ssm else 16) * 2 + inner * d
                per_layer += n_attn + n_ssm + self._layer_mlp_params(n_mlp)
            elif kind in ("slstm", "mlstm"):
                inner = self.num_heads * hd
                per_layer += d * 4 * inner + inner * d + 2 * d * max(self.d_ff, 2 * d)
        n_embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(per_layer + n_embed)

    def _layer_mlp_params(self, n_mlp: int) -> float:
        if self.moe is not None:
            m = self.moe
            n = self.d_model * m.num_experts            # router
            n += m.num_experts * 3 * self.d_model * m.expert_d_ff
            if m.num_shared_experts:                    # fused shared expert
                n += 3 * self.d_model * m.shared_expert_d_ff + self.d_model
            return n
        return n_mlp

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full_moe = self.num_layers * m.num_experts * 3 * self.d_model * m.expert_d_ff
        active_moe = self.num_layers * m.num_experts_per_tok * 3 * self.d_model * m.expert_d_ff
        return self.param_count() - full_moe + active_moe

    def reduced(self, max_d_model: int = 256, num_layers: int = 2,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (2 layers, tiny dims)."""
        d = min(self.d_model, max_d_model)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        hd = max(8, d // heads)
        d = hd * heads
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                num_experts_per_tok=min(self.moe.num_experts_per_tok, 2),
                expert_d_ff=min(self.moe.expert_d_ff, 2 * d),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                shared_expert_d_ff=min(self.moe.shared_expert_d_ff, 2 * d),
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_size=min(self.ssm.state_size, 8),
                                      num_heads=min(self.ssm.num_heads, 2))
        mrope = self.mrope_sections
        if mrope:
            half = hd // 2
            scaled = [max(1, s * half // sum(mrope)) for s in mrope]
            scaled[-1] += half - sum(scaled)
            mrope = tuple(scaled)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            mrope_sections=mrope,
            num_layers=num_layers,
            num_encoder_layers=min(self.num_encoder_layers, num_layers),
            encoder_seq_len=min(self.encoder_seq_len, 16) if self.encoder_seq_len else 0,
            num_vision_tokens=min(self.num_vision_tokens, 8) if self.num_vision_tokens else 0,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, vocab),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else None,
            moe=moe,
            ssm=ssm,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
