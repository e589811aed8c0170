"""Mamba-2 SSD inter-chunk state scan, on the card.

CUDA kernel ``csrc/ssd_scan.cu``, the port of the Pallas kernel
``repro.kernels.ssd_scan.ssd_chunk_scan``: for states (B,NC,H,P,N) and
float32 decay (B,NC,H), ``s_0 = 0, s_{c+1} = s_c * decay_c + states_c``,
returning s_c for every chunk, fp32 carry, in the states' dtype. Any shape and any
strides; the output is contiguous.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(states: torch.Tensor, decay: torch.Tensor
               ) -> Tuple[int, int, int, int, int]:
    """Validate states (B,NC,H,P,N), float32 or bfloat16, and float32
    decay (B,NC,H) (the model's ``exp`` of its f32 chunk sums), on one
    device; returns (B, NC, H, P, N)."""
    if states.dim() != 5:
        raise ValueError(f"ssd_chunk_scan: states must be (B,NC,H,P,N), got "
                         f"{tuple(states.shape)}")
    B, NC, H, P, N = states.shape
    if tuple(decay.shape) != (B, NC, H):
        raise ValueError(f"ssd_chunk_scan: decay must be ({B},{NC},{H}), "
                         f"got {tuple(decay.shape)}")
    if states.dtype not in _DTYPES or decay.dtype != torch.float32:
        raise TypeError(f"ssd_chunk_scan: states must be float32 or "
                        f"bfloat16 and decay float32, got {states.dtype}, "
                        f"{decay.dtype}")
    if decay.device != states.device:
        raise ValueError("ssd_chunk_scan: states and decay on different "
                         "devices")
    return B, NC, H, P, N


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("ssd_scan").ssd_chunk_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns (B,NC,H,P,N) contiguous."""
    B, NC, H, P, N = check_args(states, decay)
    if states.device.type != "cuda":
        raise ValueError("ssd_chunk_scan kernel needs CUDA tensors")
    if H > 65535 or B > 65535 or P * N >= 2 ** 31:
        raise ValueError(f"ssd_chunk_scan: {tuple(states.shape)} exceeds "
                         "the kernel's grid")
    out = torch.empty((B, NC, H, P, N), dtype=states.dtype,
                      device=states.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 8)(*states.stride(), *decay.stride())
    with torch.cuda.device(states.device):
        code = _launcher()(states.data_ptr(), decay.data_ptr(),
                           out.data_ptr(), B, NC, H, P, N, strides,
                           _DTYPES[states.dtype], _build.stream_ptr(states))
    _build.check_launch("ssd_scan", code)
    ssd_chunk_scan.launches += 1
    return out


ssd_chunk_scan.launches = 0
