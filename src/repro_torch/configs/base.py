"""Model configs and the DSE layer descriptor, as pure data.

An own copy of ``repro.configs.base``'s ``ModelConfig``, ``smoke``,
``ConvLayerSpec``, ``XRConfig`` and ``smoke_xr`` (the port imports nothing
of ``repro``); tests hold the two field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """LM-family architecture description (one per assigned arch)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention variants -------------------------------------------------
    sliding_window: int = 0         # 0 = full attention
    local_global_period: int = 0    # gemma2: layers alternate local/global
                                    # (layer i is LOCAL iff i % period != period-1)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    qk_norm: bool = False

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1             # MoE replaces dense MLP every `period` layers
    moe_offset: int = 0             # layer i is MoE iff i % period == offset
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0              # d_state; 0 = no SSM layers
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256            # SSD chunk length for training
    attn_period: int = 0            # hybrid: layer i is ATTENTION iff
    attn_offset: int = 0            #   i % attn_period == attn_offset (else SSM)

    # --- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    cross_attention: bool = False
    num_encoder_frames: int = 0     # stub conv-frontend output length

    # --- VLM stub (phi-3-vision) ----------------------------------------------
    num_image_tokens: int = 0       # precomputed patch embeddings merged in

    # --- misc -----------------------------------------------------------------
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    mlp_gated: bool = True          # False: plain 2-layer MLP (whisper)
    sandwich_norm: bool = False     # gemma2: post-sublayer norms before residual
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embedding: bool = False   # gemma2: x *= sqrt(d_model) after lookup
    dtype: str = "bfloat16"
    # Scaled-down flag (smoke tests).
    is_smoke: bool = False
    # Whether a 500k-token decode is admissible (sub-quadratic memory growth).
    sub_quadratic: bool = False
    # The next three fields are read by the JAX package's training, dry-run
    # and decode paths; the port keeps them so the two configs compare field
    # by field. remat and scan_layers change nothing here (the port runs a
    # Python loop over repeats); swa_ring_buffer needs a sliding window,
    # which is not ported.
    remat: bool = True              # activation checkpointing in train_step
    swa_ring_buffer: bool = False   # ring-buffer KV cache, sliding layers
    scan_layers: bool = True        # lax.scan over repeats in the reference
    # Decode-path score chain (mask/softmax over the full KV length) in
    # bf16 after the fp32 QK dot: halves the bytes of every cache-length
    # elementwise op at ~1e-2 relative logit noise.
    decode_bf16_scores: bool = False
    # INT8 KV cache with per-(position, head) scales: halves the cache
    # footprint and its read/write bytes.
    kv_cache_int8: bool = False

    # ---------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid stacks: which sub-layers carry attention."""
        if self.ssm_state == 0:
            return True
        if self.attn_period == 0:
            return False                     # pure SSM
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_period == self.moe_offset

    def is_local_layer(self, i: int) -> bool:
        """gemma2-style alternation: every `period`-th layer is global."""
        if self.sliding_window == 0:
            return False
        if self.local_global_period == 0:
            return True                      # uniform sliding window (mistral)
        return i % self.local_global_period != self.local_global_period - 1

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline cross-check)."""
        V, D, L = self.vocab_size, self.d_model, self.num_layers
        total = V * D                        # input embedding
        if not self.tie_embeddings:
            total += V * D                   # output head
        for i in range(L):
            total += self._layer_params(i)
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                attn = D * (self.q_dim + 2 * self.kv_dim) + self.q_dim * D
                mlp = 2 * D * self.d_ff + self.d_ff * D
                total += attn + mlp + 2 * D
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        V, D, L = self.vocab_size, self.d_model, self.num_layers
        total = V * D + (0 if self.tie_embeddings else V * D)
        for i in range(L):
            total += self._layer_params(i, active_only=True)
        return total

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        D = self.d_model
        n = 0
        if self.is_attn_layer(i):
            n += D * (self.q_dim + 2 * self.kv_dim) + self.q_dim * D
            n += 2 * D                        # norms
        elif self.ssm_state:
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ds
            n += D * (2 * di + 2 * ds + nh)   # in_proj
            n += conv_dim * self.ssm_conv_width
            n += 3 * nh                       # A_log, D, dt_bias
            n += di * D + di + D              # out_proj + gated norm + norm
        # MLP / MoE
        if self.d_ff:
            gate_up = 2 * D * self.d_ff
            down = self.d_ff * D
            if self.is_moe_layer(i):
                e = self.num_experts if not active_only else self.experts_per_token
                n += e * (gate_up + down) + D * self.num_experts  # + router
            else:
                n += gate_up + down
            n += D                            # mlp norm
        if self.cross_attention:
            n += D * (self.q_dim + 2 * self.kv_dim) + self.q_dim * D + D
        return n


@dataclass(frozen=True)
class ConvLayerSpec:
    """One conv layer for the DSE workload extractor (paper plane).

    Operand bit-widths are per-layer fields so mixed-precision networks
    price each operand class at its stored width. ``psum_bits=None``
    derives the accumulator width from the operand widths (``psum_width``);
    the INT8 default reproduces the paper's 8b x 8b -> 24b datapath.
    """
    name: str
    kind: str            # conv | dwconv | dense
    in_ch: int
    out_ch: int
    kernel: int          # k (square) ; 1 for dense
    stride: int
    in_hw: Tuple[int, int]
    weight_bits: int = 8           # stored weight operand width
    act_bits: int = 8              # stored activation operand width
    psum_bits: Optional[int] = None  # None -> weight_bits + act_bits + 8

    @property
    def psum_width(self) -> int:
        """Partial-sum width: product width plus 8 guard bits."""
        if self.psum_bits is not None:
            return self.psum_bits
        return self.weight_bits + self.act_bits + 8

    @property
    def out_hw(self) -> Tuple[int, int]:
        return (max(1, self.in_hw[0] // self.stride),
                max(1, self.in_hw[1] // self.stride))

    @property
    def macs(self) -> int:
        oh, ow = self.out_hw
        if self.kind == "dwconv":
            return oh * ow * self.out_ch * self.kernel * self.kernel
        if self.kind == "dense":
            return self.in_ch * self.out_ch
        return oh * ow * self.out_ch * self.in_ch * self.kernel * self.kernel

    @property
    def weight_elems(self) -> int:
        if self.kind == "dwconv":
            return self.out_ch * self.kernel * self.kernel
        if self.kind == "dense":
            return self.in_ch * self.out_ch
        return self.in_ch * self.out_ch * self.kernel * self.kernel

    @property
    def in_elems(self) -> int:
        return self.in_hw[0] * self.in_hw[1] * self.in_ch

    @property
    def out_elems(self) -> int:
        oh, ow = self.out_hw
        return oh * ow * self.out_ch

    @property
    def weight_bytes(self) -> int:
        return (self.weight_elems * self.weight_bits + 7) // 8

    @property
    def in_bytes(self) -> int:
        return (self.in_elems * self.act_bits + 7) // 8

    @property
    def out_bytes(self) -> int:
        return (self.out_elems * self.act_bits + 7) // 8


@dataclass(frozen=True)
class XRConfig:
    """Paper workloads: convolutional XR nets (DetNet / EDSNet)."""
    name: str
    family: str = "xr"
    input_hw: Tuple[int, int] = (128, 128)
    in_channels: int = 3
    width_mult: float = 1.0
    num_classes: int = 4            # EDSNet segmentation classes
    task: str = "detection"         # detection | segmentation
    # MobileNetV2 inverted-residual stages: (expansion t, channels c, repeats n, stride s)
    stages: Tuple[Tuple[int, int, int, int], ...] = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )
    stem_channels: int = 32
    head_channels: int = 1280
    decoder_channels: Tuple[int, ...] = (256, 128, 64, 32, 16)  # UNet decoder
    is_smoke: bool = False


def smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    base = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // max(1, cfg.num_heads))),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        is_smoke=True,
        remat=False,
    )
    if cfg.num_experts:
        base["num_experts"] = min(4, cfg.num_experts)
        base["experts_per_token"] = min(2, cfg.experts_per_token)
    if cfg.ssm_state:
        base["ssm_state"] = 16
        base["ssm_head_dim"] = 16
        base["ssm_chunk"] = 32
    if cfg.attn_period:
        base["attn_period"] = min(4, cfg.attn_period)
        base["attn_offset"] = min(cfg.attn_offset, base["attn_period"] - 1)
        base["num_layers"] = 2 * base["attn_period"]
    if cfg.local_global_period:
        base["local_global_period"] = 2
    if cfg.sliding_window:
        base["sliding_window"] = 16
    if cfg.encoder_layers:
        base["encoder_layers"] = 2
        base["num_encoder_frames"] = 24
    if cfg.num_image_tokens:
        base["num_image_tokens"] = 8
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


def smoke_xr(cfg: XRConfig, **overrides) -> XRConfig:
    """Reduced config of the same task for CPU smoke tests."""
    base = dict(
        input_hw=(32, 32) if cfg.task == "detection" else (32, 64),
        width_mult=0.25,
        stages=((1, 8, 1, 1), (6, 12, 1, 2), (6, 16, 1, 2)),
        stem_channels=8,
        head_channels=64,
        decoder_channels=(32, 16, 8),
        is_smoke=True,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
