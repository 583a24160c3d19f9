"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B].

48 layers, d_model 2048, 32 heads (GQA kv=4, head_dim 128), vocab 151936.
MoE: 128 experts, top-8 routing, expert FFN width 768, no shared experts.
Distinctives: per-head RMS QK-norm, SwiGLU experts, RMSNorm, RoPE 1e6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,                      # == expert width; every MLP is MoE
    vocab_size=151_936,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=128,
        num_experts_per_tok=8,
        expert_d_ff=768,
        num_shared_experts=0,
        shared_expert_d_ff=0,
        router_aux_loss_coef=0.001,
    ),
    supports_long_context=False,   # full attention
)
