"""xLSTM 350M [arXiv:2405.04517].

Attention-free recurrent stack: 24 blocks, d_model 1024, 4 heads,
vocab 50304, alternating mLSTM (matrix memory, covariance update) and
sLSTM (scalar memory, exponential gating) blocks; no separate FFN
(d_ff=0 — the blocks carry their own up/down projections).  Constant-
size recurrent state means decode cost is O(1) in context length, so
this arch runs long_500k natively.

The assigned spec's "GQA kv=4" describes the head grouping of the
recurrent cells (4 heads, per-head state), not attention.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    arch_type="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=256,
    mlp_type="none",
    norm_type="layernorm",
    pos_embedding="none",          # recurrence encodes position
    layer_pattern=("mlstm", "slstm"),
    ssm=SSMConfig(state_size=16, conv_width=4, expand=2, num_heads=4),
    tie_embeddings=True,
    supports_long_context=True,
)
