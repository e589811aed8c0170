"""phi-3-vision-4.2b -- phi3-mini backbone + CLIP frontend (stubbed) (own
copy of ``repro.configs.phi3_vision_4p2b``).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (GQA kv=32 => MHA) d_ff=8192 vocab=32064.
The vision frontend is a stub: the caller supplies 256 precomputed patch
embeddings that replace the first 256 token positions.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_image_tokens=256,
    rope_theta=10_000.0,
    act="silu",
    sub_quadratic=False,
)

SMOKE = smoke(CONFIG)
