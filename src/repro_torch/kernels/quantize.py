"""Fused per-row INT8 quantize (absmax -> scale -> round -> clip) on the card.

CUDA kernel ``csrc/quantize.cu``, the port of the Pallas kernel
``repro.kernels.quantize.quantize_rows``. Codes and scales equal the plain
version's bit for bit: a true division and round-half-to-even.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build


def check_args(x: torch.Tensor) -> Tuple[int, int]:
    """Validate x (M,N) float32 contiguous; returns (M, N)."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows: x must be (M,N), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_rows: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_rows: x must be contiguous")
    if x.shape[1] == 0:
        raise ValueError("quantize_rows: rows must not be empty")
    return x.shape[0], x.shape[1]


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("quantize").quantize_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA tensor; returns (codes int8 (M,N),
    scales f32 (M,))."""
    M, N = check_args(x)
    if x.device.type != "cuda":
        raise ValueError("quantize_rows kernel needs a CUDA tensor")
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, s
    with torch.cuda.device(x.device):
        code = _launcher()(x.data_ptr(), q.data_ptr(), s.data_ptr(), M, N,
                           _build.stream_ptr(x))
    _build.check_launch("quantize", code)
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0
