"""Gemma-2 9B [arXiv:2408.00118].

Dense decoder: 42 layers, d_model 3584, 16 heads (GQA kv=8, head_dim 256),
d_ff 14336, vocab 256000.  Distinctives: alternating local(4096-window) /
global attention, attention-logit softcap 50, final-logit softcap 30,
GeGLU MLP, RMSNorm (pre+post), tied embeddings.

long_500k policy: local layers keep a 4096-window cache; the global
layers' 500k KV cache is sequence-sharded across the `data` mesh axis,
so this arch *runs* long_500k as the sliding-window dense variant.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256_000,
    head_dim=256,
    mlp_type="gelu_glu",
    norm_type="rmsnorm",
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    layer_pattern=("local", "attn"),
    scale_embedding=True,
    tie_embeddings=True,
    supports_long_context=True,
)
