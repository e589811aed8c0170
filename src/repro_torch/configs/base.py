"""XR model configs and the DSE layer descriptor, as pure data.

An own copy of ``repro.configs.base``'s ``ConvLayerSpec``, ``XRConfig`` and
``smoke_xr`` (the port imports nothing of ``repro``); tests hold the two
field by field. ``ModelConfig`` and the LM configs wait for the LM slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


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
