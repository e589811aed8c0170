"""Fused per-row INT8 quantize (absmax -> scale -> round -> clip) on the card.

CUDA kernel ``csrc/quantize.cu``, the port of the Pallas kernel
``repro.kernels.quantize.quantize_rows``. Codes and scales equal the plain
version's bit for bit: a true division and round-half-to-even. Each row is
read from device memory once, except rows longer than ``MAX_REG_N``;
``plan`` picks how many lanes hold a row for each row width.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

THREADS = 256                  # the kernels' block
MAX_VPL = 16                   # 16-byte slots per lane (64 floats in registers)
MAX_REG_N = 32 * 4 * MAX_VPL   # longest row one warp holds in registers
MAX_GRID_X = 2 ** 31 - 1


class Plan(NamedTuple):
    """How the kernel covers an (M, N) input: ``lanes`` lanes per row (a
    power of two; 32 // lanes rows per warp), each holding ``vpl`` 16-byte
    slots of the row in registers, ``rows_per_block`` rows in each of
    ``blocks`` blocks of THREADS; or, for rows longer than MAX_REG_N,
    ``vpl`` 0 and one block per row (read twice, the second time from L2)."""
    lanes: int
    vpl: int
    rows_per_block: int
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int) -> Plan:
    """Lanes for (M, N), N >= 1: for N <= 128 a row takes ceil(N/4) lanes,
    rounded up to a power of two so the absmax reduces with shuffles inside
    the group, and a warp holds several rows; up to MAX_REG_N a warp per
    row with ceil(N/128) slots a lane (rounded up to a power of two);
    beyond, a block per row."""
    n4 = -(-N // 4)
    if N > MAX_REG_N:
        return Plan(THREADS, 0, 1, M)
    lanes = _pow2_at_least(min(n4, 32))
    vpl = _pow2_at_least(-(-n4 // 32)) if n4 > 32 else 1
    rows = THREADS // 32 * (32 // lanes)
    return Plan(lanes, vpl, rows, -(-M // rows))


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
        ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on a CUDA tensor on ``plan(M, N)``; returns (codes
    int8 (M,N), scales f32 (M,)). 16-byte loads where N % 4 == 0 and x is
    16-byte aligned, element loads otherwise."""
    M, N = check_args(x)
    if x.device.type != "cuda":
        raise ValueError("quantize_rows kernel needs a CUDA tensor")
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    s = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, s
    p = plan(M, N)
    if p.blocks > MAX_GRID_X or N > 2 ** 31 - 1:
        raise ValueError(f"quantize_rows: {M}x{N} exceeds the kernel's grid")
    vec = int(N % 4 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        code = _launcher()(x.data_ptr(), q.data_ptr(), s.data_ptr(), M, N,
                           p.lanes, p.vpl, vec, p.blocks,
                           _build.stream_ptr(x))
    _build.check_launch("quantize", code)
    quantize_rows.launches += 1
    return q, s


quantize_rows.launches = 0
