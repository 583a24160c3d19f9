"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head architecture: every layer runs attention heads and Mamba
(SSM) heads *in parallel* on the same input, outputs mean-fused.
32 layers, d_model 1600, 25 attn heads (GQA kv=5), d_ff 5504, vocab 32001,
ssm_state 16.  Most attention is sliding-window (Hymba keeps only 3 global
layers); this is the SWA variant, so the constant-size cache + SSM state
qualifies the arch for long_500k decode.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    sliding_window=1024,
    layer_pattern=("hymba",),
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2),
    supports_long_context=True,    # SWA cache + constant SSM state
)
