"""Causal / non-causal attention with an online softmax, on the card.

CUDA kernels ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``: scale 1/sqrt(D), fp32
running max, denominator and accumulator, causal mask -1e30, key tiles above
the diagonal skipped, output in q's dtype. The dtype picks the kernel: bf16
runs both products on the tensor cores (wgmma), rounding the probabilities
to bf16 before the PV product as the model's reference does; f32 runs fp32
FMAs on the CUDA cores. Both take what the Pallas kernel does not: any S
(no tiling contract), grouped-query k/v with fewer heads than q, and strided
(B,H,S,D) views such as the transpose of the model's seq-major (B,S,H,D)
projections.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Llama-3.2-1B's head dim, and its smoke config's (the CPU tests run the
# smoke model through the same argument checks)
HEAD_DIMS = (32, 64)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[int, int, int, int, int]:
    """Validate q (B,H,S,D) and k, v (B,K,S,D) with K dividing H, one dtype
    (f32 or bf16), one device, the last dim contiguous; returns
    (B, H, S, D, H // K). Raises on anything else."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be (B,H,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: k, v must be (B,K,S,D) = "
                         f"({B},K,{S},{D}), got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    K = k.shape[1]
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {K} kv heads do not divide "
                         f"{H} query heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    return B, H, S, D, H // K


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. Returns (B,H,S,D) in q's dtype,
    a view of a (B,S,H,D) contiguous tensor, so ``out.transpose(1, 2)``
    is the model's seq-major layout without a copy."""
    B, H, S, D, G = check_args(q, k, v)
    if q.device.type != "cuda":
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if H > 65535 or B > 65535 or -(-S // 64) > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H}, S={S} exceed the "
                         "kernel's grid")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))
            for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel loads 16-byte "
                         "rows: base pointers and (batch, head, seq) strides "
                         "must be 16-byte aligned")
    o = torch.empty((B, S, H, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, o)
                                      for i in range(3)))
    with torch.cuda.device(q.device):
        code = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), B, H, S, D, G, int(causal),
                           1.0 / math.sqrt(D), strides, _DTYPES[q.dtype],
                           _build.stream_ptr(q))
    _build.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
