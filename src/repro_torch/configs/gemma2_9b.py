"""gemma2-9b — dense, local/global alternating attention, logit softcaps.
Own copy of ``repro.configs.gemma2_9b``.

[arXiv:2408.00118; hf]
42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, head_dim=256,
sliding window 4096 on local layers (alternate local/global), attn softcap 50,
final softcap 30, GeGLU.
"""
from repro_torch.configs.base import ModelConfig, smoke

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    sliding_window=4096,
    local_global_period=2,          # local, global, local, global ...
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    sandwich_norm=True,
    tie_embeddings=True,
    scale_embedding=True,
    sub_quadratic=False,
    # ring-buffer KV cache (window long) on the 21 local layers
    swa_ring_buffer=True,
)

SMOKE = smoke(CONFIG)
