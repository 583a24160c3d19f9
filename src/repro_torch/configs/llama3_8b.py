"""Llama-3 8B [arXiv:2407.21783].

Dense decoder: 32 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 128256, SwiGLU, RMSNorm, RoPE theta 500k, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=500_000.0,
    tie_embeddings=False,
    supports_long_context=False,   # pure full attention -> skip long_500k
)
