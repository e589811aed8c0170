"""mixtral-8x7b — sparse MoE (8 experts, top-2) with sliding-window attention.
Own copy of ``repro.configs.mixtral_8x7b``.

[arXiv:2401.04088; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding window 4096 on every layer.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    num_experts=8,
    experts_per_token=2,
    moe_period=1,
    sliding_window=4096,
    act="silu",
    sub_quadratic=False,
    # every layer is sliding-window: a ring-buffer KV cache (window long)
    swa_ring_buffer=True,
)

SMOKE = smoke(CONFIG)
