"""whisper-small -- encoder-decoder speech model; conv frontend stubbed (own
copy of ``repro.configs.whisper_small``).

[arXiv:2212.04356; unverified]
12L encoder + 12L decoder, d_model=768 12H (MHA) d_ff=3072 vocab=51865.
The caller supplies precomputed mel-frame embeddings (B, 1500, 768): the
strided-conv frontend is a stub. Decode carries a self-attention cache of
the sequence and a cross-attention cache of the 1500 frames.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,                 # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    encoder_layers=12,
    cross_attention=True,
    num_encoder_frames=1500,
    act="gelu",
    mlp_gated=False,               # whisper: plain fc1-gelu-fc2 MLP
    rope_theta=0.0,                # sinusoidal absolute positions, no RoPE
    tie_embeddings=True,
    sub_quadratic=False,
)

SMOKE = smoke(CONFIG)
