"""deepseek-7b — llama-architecture dense model (own copy of
``repro.configs.deepseek_7b``).

[arXiv:2401.02954; hf]
30L d_model=4096 32H (GQA kv=32 => MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102_400,
    act="silu",
    sub_quadratic=False,
)

SMOKE = smoke(CONFIG)
