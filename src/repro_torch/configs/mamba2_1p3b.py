"""mamba2-1.3b -- attention-free SSM stack (SSD / state-space duality), own
copy of ``repro.configs.mamba2_1p3b``.

[arXiv:2405.21060; unverified]
48L d_model=2048, d_state=128, expand=2 (d_inner=4096), head_dim=64
(64 SSM heads), conv width 4, vocab 50280.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # mamba2 blocks have no separate MLP
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    attn_period=0,               # pure SSM
    tie_embeddings=True,
    sub_quadratic=True,
)

SMOKE = smoke(CONFIG)
