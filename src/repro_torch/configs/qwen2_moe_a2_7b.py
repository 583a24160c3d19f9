"""Qwen2-MoE A2.7B (Qwen1.5-MoE-A2.7B) [hf:Qwen/Qwen1.5-MoE-A2.7B].

24 layers, d_model 2048, 16 heads (MHA kv=16), vocab 151936.
MoE: 60 routed experts top-4 (expert FFN width 1408) + 4 shared experts
(realized as one fused shared expert of width 4*1408=5632 with a
sigmoid shared-expert gate, matching the HF reference).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                     # routed expert width
    vocab_size=151_936,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        num_experts=60,
        num_experts_per_tok=4,
        expert_d_ff=1408,
        num_shared_experts=4,      # fused: one gated expert of width 5632
        shared_expert_d_ff=5632,
        router_aux_loss_coef=0.001,
    ),
    supports_long_context=False,   # full attention -> skip long_500k
)
