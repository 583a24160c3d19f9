"""OLMo 1B [arXiv:2402.00838].

Dense decoder: 16 layers, d_model 2048, 16 heads (MHA: kv=16), d_ff 8192,
vocab 50304.  Distinctives: non-parametric LayerNorm (no scale/bias),
SwiGLU, tied embeddings, RoPE.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="nonparametric",
    rope_theta=10_000.0,
    tie_embeddings=True,
    supports_long_context=False,   # pure full attention -> skip long_500k
)
