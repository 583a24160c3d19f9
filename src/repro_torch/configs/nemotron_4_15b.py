"""Nemotron-4 15B [arXiv:2402.16819].

Dense decoder: 32 layers, d_model 6144, 48 heads (GQA kv=8), d_ff 24576,
vocab 256000.  Distinctives: squared-ReLU MLP (no gating), LayerNorm,
untied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256_000,
    head_dim=128,
    mlp_type="relu2",
    norm_type="layernorm",
    rope_theta=10_000.0,
    tie_embeddings=False,
    supports_long_context=False,   # pure full attention -> skip long_500k
)
