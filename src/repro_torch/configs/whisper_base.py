"""Whisper base [arXiv:2212.04356] — transformer backbone only.

Encoder-decoder: 6+6 layers, d_model 512, 8 heads (MHA), d_ff 2048,
vocab 51865.  GELU MLP, LayerNorm, sinusoidal encoder positions /
learned decoder positions (we use learned absolute positions for both
and no RoPE, matching Whisper's decoder).  The mel-spectrogram + conv
frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings (1500 x d_model, i.e. 30 s of audio after
the conv stride-2).

Decode shapes apply (it is an encoder-*decoder*); the decoder is full
attention with a 448-token design ceiling, so long_500k is skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,                  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    head_dim=64,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_embedding="learned",
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq_len=1500,          # stub conv frontend output length
    tie_embeddings=True,
    supports_long_context=False,   # full-attn decoder, 448-token ceiling
)
