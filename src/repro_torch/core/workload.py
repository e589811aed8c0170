"""Workload extraction: model config -> list[ConvLayerSpec] for the mapper.

Two producers share one descriptor type:
  * XR convnets (the paper's workloads) — extracted from the same plan that
    builds the port's model (``repro_torch.models.xr.conv_layer_specs``), so
    the DSE engine prices exactly the network we train and quantize.
  * LM decode/prefill steps (beyond-paper) — each matmul becomes a ``dense``
    descriptor. The KV-cache read is deliberately classified as a
    *weight-class* operand (``attn_kv*`` dense specs): during decode the
    cache is read S times per single write, i.e. read-mostly like weights —
    which is precisely the asymmetry the paper's P0 question targets.
    (GQA grouping means MACs are undercounted by H/K for these specs; cache
    BYTES — the quantity that dominates systolic energy — are exact.
    Documented in DESIGN.md §Arch-applicability.)
"""
from __future__ import annotations

from typing import List, Union

from repro_torch.configs.base import ConvLayerSpec, ModelConfig, XRConfig


def xr_specs(cfg: XRConfig) -> List[ConvLayerSpec]:
    from repro_torch.models.xr import conv_layer_specs   # lazy: pulls torch
    return conv_layer_specs(cfg)


def _dense(name: str, d_in: int, d_out: int) -> ConvLayerSpec:
    return ConvLayerSpec(name, "dense", d_in, d_out, 1, 1, (1, 1))


def lm_decode_specs(cfg: ModelConfig, context_len: int = 4096
                    ) -> List[ConvLayerSpec]:
    """One-token decode step as a layer list (per-layer matmuls + KV reads)."""
    specs: List[ConvLayerSpec] = []
    D = cfg.d_model
    for i in range(cfg.num_layers):
        pre = f"l{i}_"
        if cfg.is_attn_layer(i):
            specs += [_dense(pre + "wq", D, cfg.q_dim),
                      _dense(pre + "wk", D, cfg.kv_dim),
                      _dense(pre + "wv", D, cfg.kv_dim),
                      _dense(pre + "wo", cfg.q_dim, D)]
            ctx = context_len
            if cfg.is_local_layer(i) and cfg.sliding_window:
                ctx = min(ctx, cfg.sliding_window)
            specs += [_dense(pre + "attn_kv_k", ctx, cfg.kv_dim),
                      _dense(pre + "attn_kv_v", ctx, cfg.kv_dim)]
        elif cfg.ssm_state:
            di = cfg.d_inner
            specs += [_dense(pre + "ssm_in", D, 2 * di + 2 * cfg.ssm_state
                             + cfg.ssm_heads),
                      _dense(pre + "ssm_state", cfg.ssm_state, di),
                      _dense(pre + "ssm_out", di, D)]
        if cfg.d_ff:
            n_mlp = cfg.experts_per_token if cfg.is_moe_layer(i) else 1
            for e in range(n_mlp):
                sfx = f"_e{e}" if n_mlp > 1 else ""
                specs += [_dense(pre + "mlp_gate" + sfx, D, cfg.d_ff),
                          _dense(pre + "mlp_up" + sfx, D, cfg.d_ff),
                          _dense(pre + "mlp_down" + sfx, cfg.d_ff, D)]
    specs.append(_dense("unembed", D, cfg.vocab_size))
    return specs


def extract(cfg: Union[ModelConfig, XRConfig], **kw) -> List[ConvLayerSpec]:
    if isinstance(cfg, XRConfig):
        return xr_specs(cfg)
    return lm_decode_specs(cfg, **kw)
