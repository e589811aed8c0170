"""jamba-1.5-large-398b -- hybrid Mamba+attention (1:7) with MoE (16e top-2).
Own copy of ``repro.configs.jamba_1p5_large_398b``.

[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts top-2
every other layer, attention every 8th layer (1 attn : 7 mamba).
Sub-quadratic memory growth (attention layers are 1/8 of the stack, and the
SSM state is O(1)).
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    num_experts=16,
    experts_per_token=2,
    moe_period=2,
    moe_offset=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=256,
    attn_period=8,
    attn_offset=4,
    sub_quadratic=True,
)

SMOKE = smoke(CONFIG)
