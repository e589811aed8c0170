"""yi-34b — llama-architecture dense model with aggressive GQA.
Own copy of ``repro.configs.yi_34b``.

[arXiv:2403.04652; hf]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    act="silu",
    sub_quadratic=False,
)

SMOKE = smoke(CONFIG)
