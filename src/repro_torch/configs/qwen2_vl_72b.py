"""Qwen2-VL 72B [arXiv:2409.12191] — language backbone only.

80 layers, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
Distinctives: Multimodal RoPE (M-RoPE) splitting each head's rotary dims
into temporal/height/width sections (16/24/24 of head_dim/2=64), dynamic-
resolution vision input.  Per the assignment the ViT frontend is a STUB:
``input_specs()`` supplies precomputed patch embeddings (a
``num_vision_tokens x d_model`` prefix merged before the text tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    rope_theta=1_000_000.0,
    use_mrope=True,
    mrope_sections=(16, 24, 24),   # t/h/w splits of head_dim//2
    num_vision_tokens=256,         # stub frontend: 256 patch embeddings
    tie_embeddings=False,
    supports_long_context=False,   # full attention -> skip long_500k
)
