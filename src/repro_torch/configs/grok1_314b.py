"""grok-1-314b — large sparse MoE (8 experts, top-2).
Own copy of ``repro.configs.grok1_314b``.

[hf:xai-org/grok-1; unverified]
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, 8 experts top-2.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    num_experts=8,
    experts_per_token=2,
    moe_period=1,
    attn_logit_softcap=30.0,
    act="gelu",
    sub_quadratic=False,
)

SMOKE = smoke(CONFIG)
