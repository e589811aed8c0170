"""Depthwise 3x3 conv on the card (the IRB hot path of the paper's networks).

CUDA kernel ``csrc/depthwise_conv.cu``, the port of the Pallas kernel
``repro.kernels.depthwise_conv.depthwise_conv3x3_padded``: NHWC, stride 1,
SAME padding, fp32 accumulation, output in the input dtype (f32 or bf16).
It takes any B, H, W and C: there is no tiling contract and no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TH, _TW = 8, 16                    # the kernel's spatial tile


def check_args(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate (x (B,H,W,C) contiguous, w (C,1,3,3) contiguous, of x's
    dtype and device); returns (B, H, W, C). Raises on anything else."""
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv3x3: x must be (B,H,W,C), got "
                         f"{tuple(x.shape)}")
    B, H, W, C = x.shape
    if tuple(w.shape) != (C, 1, 3, 3):
        raise ValueError(f"depthwise_conv3x3: w must be ({C},1,3,3), got "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv3x3: x and w must both be float32 "
                        f"or bfloat16, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError("depthwise_conv3x3: x and w on different devices")
    if not x.is_contiguous():
        raise ValueError("depthwise_conv3x3: x must be contiguous NHWC (a "
                         "channels_last NCHW tensor permuted to NHWC)")
    if not w.is_contiguous():
        raise ValueError("depthwise_conv3x3: w must be contiguous")
    return B, H, W, C


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("depthwise_conv").depthwise_conv3x3_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors x (B,H,W,C), w (C,1,3,3)."""
    B, H, W, C = check_args(x, w)
    if x.device.type != "cuda":
        raise ValueError("depthwise_conv3x3 kernel needs CUDA tensors")
    tiles = -(-H // _TH) * -(-W // _TW)
    if tiles > 65535 or B > 65535:
        raise ValueError(f"depthwise_conv3x3: {B}x{H}x{W} exceeds the "
                         "kernel's grid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        code = _launcher()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                           B, H, W, C, _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check_launch("depthwise_conv", code)
    depthwise_conv3x3.launches += 1
    return y


depthwise_conv3x3.launches = 0
