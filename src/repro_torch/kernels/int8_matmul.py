"""INT8 GEMM with fused per-row x per-column dequant, on the card.

CUDA kernel ``csrc/int8_matmul.cu``, the port of the Pallas kernel
``repro.kernels.int8_matmul.int8_matmul``: (M,K) int8 x (K,N) int8 with an
exact int32 accumulation, then ``(f32(acc) * a_scale[m]) * b_scale[n]``.
Any M, N and K: ragged edges are masked, there is no tiling contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

# (-128)^2 * K must fit the int32 accumulator
MAX_K = 2 ** 31 // 128 ** 2 - 1
_BM = 64


def check_args(a, b, a_scale, b_scale) -> Tuple[int, int, int]:
    """Validate the operands; returns (M, N, K). Raises on anything else."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: need (M,K) x (K,N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if tuple(a_scale.shape) != (M,) or tuple(b_scale.shape) != (N,):
        raise ValueError(f"int8_matmul: scales must be ({M},) and ({N},), "
                         f"got {tuple(a_scale.shape)}, {tuple(b_scale.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands must be int8, got {a.dtype}, "
                        f"{b.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError("int8_matmul: scales must be float32")
    if len({t.device for t in (a, b, a_scale, b_scale)}) != 1:
        raise ValueError("int8_matmul: operands on different devices")
    if not all(t.is_contiguous() for t in (a, b, a_scale, b_scale)):
        raise ValueError("int8_matmul: operands must be contiguous")
    if K > MAX_K:
        raise ValueError(f"int8_matmul: K={K} can overflow the int32 "
                         f"accumulator (K <= {MAX_K})")
    return M, N, K


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("int8_matmul").int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (M,N) float32."""
    M, N, K = check_args(a, b, a_scale, b_scale)
    if a.device.type != "cuda":
        raise ValueError("int8_matmul kernel needs CUDA tensors")
    if -(-M // _BM) > 65535:
        raise ValueError(f"int8_matmul: M={M} exceeds the kernel's grid")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    with torch.cuda.device(a.device):
        code = _launcher()(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                           b_scale.data_ptr(), out.data_ptr(), M, N, K,
                           _build.stream_ptr(a))
    _build.check_launch("int8_matmul", code)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
