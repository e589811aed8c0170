"""INT8 GEMM with fused per-row x per-column dequant, on the card.

CUDA kernel ``csrc/int8_matmul.cu``, the port of the Pallas kernel
``repro.kernels.int8_matmul.int8_matmul``: (M,K) int8 x (K,N) int8 with an
exact int32 accumulation on the int8 tensor cores (wgmma), then
``(f32(acc) * a_scale[m]) * b_scale[n]``, bit-equal to ``ref.int8_matmul``.
Any M, N and K up to ``MAX_K``: ragged edges are zero-filled, there is no
tiling contract. ``plan`` picks the kernel's tile for each shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# (-128)^2 * K must fit the int32 accumulator
MAX_K = 2 ** 31 // 128 ** 2 - 1
# output columns per block (the wgmma N) that csrc/int8_matmul.cu
# instantiates: int8 wgmma takes N = 8, 16, 24 and multiples of 16 to 256
WGMMA_N = (8, 16, 24, 32, 48, 64, 96, 128, 144, 160, 192, 256)
BK = 128                      # k bytes per k-tile: four wgmma k32 steps
MAX_STAGES = 4
SMEM_MAX = 232448             # dynamic shared memory a block may use
SMS = 132                     # H100 SXM streaming multiprocessors
MAX_GRID_X, MAX_GRID_Y = 2 ** 31 - 1, 65535


class Plan(NamedTuple):
    """The kernel's tile for one (M, N, K): blocks of ``threads`` (one or
    two warpgroups of 64 rows, ``bm`` rows) x ``bn`` columns on ``grid``
    (M on x, N on y); K in 128-byte k-tiles through a ring of ``stages``;
    ``smem`` bytes of dynamic shared memory. The copy widths depend on the
    base pointers too, and ``copy_widths`` picks them at each launch."""
    bn: int
    threads: int
    bm: int
    stages: int
    grid: Tuple[int, int]
    smem: int


def unit_n(bn: int) -> int:
    """n-bytes of one B transpose unit (4 k-rows each), as the kernel's
    Tile<BN>::UN; B copies are at most this wide."""
    return 16 if bn % 16 == 0 else 8


def raw_pitch(bn: int) -> int:
    """Row pitch in bytes of the raw (N-major) B tile, as Tile<BN>::RP."""
    return -(-bn // 128) * 128


def epilogue_ld(bn: int) -> int:
    """Row stride in floats of the f32 epilogue tile: 8 (mod 32), as the
    kernel's Tile<BN>::LD."""
    return bn + (40 - bn % 32) % 32


def copy_bytes(stride: int, widest: int = 16, ptr: int = 0) -> int:
    """The widest of 16, 8 and 4 bytes (at most ``widest``) that divides
    the row stride and the base pointer, else 1 (byte copies)."""
    for w in (16, 8, 4):
        if w <= widest and stride % w == 0 and ptr % w == 0:
            return w
    return 1


def copy_widths(bn: int, K: int, N: int, a_ptr: int = 0, b_ptr: int = 0,
                out_ptr: int = 0) -> Tuple[int, int, int]:
    """Bytes per A copy (at most 16) and per B copy (at most a transpose
    unit, ``unit_n(bn)``) and floats per output store (4 or 1) that the row
    strides K and N and the base pointers allow."""
    return (copy_bytes(K, 16, a_ptr), copy_bytes(N, unit_n(bn), b_ptr),
            4 if N % 4 == 0 and out_ptr % 16 == 0 else 1)


def _width(N: int) -> int:
    if N <= WGMMA_N[-1]:
        return min(w for w in WGMMA_N if w >= N)
    # wider N: the fewest padded columns, counting 32 per extra block
    return min(WGMMA_N, key=lambda w: (-(-N // w) * (w + 32), -w))


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, K: int) -> Plan:
    """Tile for an (M, K) x (K, N) product, M, N, K >= 1. BN is N rounded
    up to a wgmma width for N <= 256, so a block owns whole output rows and
    writes one contiguous span; wider N is split into equal BN-wide tiles.
    Two warpgroups (BM = 128) unless one (BM = 64) is needed to give the
    card's SMs a block each. A ring slot holds a k-tile's
    A and raw B; the ring holds all of K up to MAX_STAGES slots, and at
    least 3 where K has more (the kernel fetches two tiles ahead), beside
    two K-major B tiles; the f32 epilogue tile reuses it all."""
    bn = _width(N)
    gy = -(-N // bn)
    threads = 256
    if -(-M // 128) * gy < SMS:
        threads = 128
    bm = threads // 2
    nkt = -(-K // BK)
    slot = bm * BK + BK * raw_pitch(bn)
    kmajor = min(2, nkt) * bn * BK
    epi = bm * epilogue_ld(bn) * 4

    def smem(stages):
        return 1024 + max(stages * slot + kmajor, epi)
    stages = min(MAX_STAGES, nkt)
    while stages > 3 and smem(stages) > SMEM_MAX:
        stages -= 1
    return Plan(bn, threads, bm, stages, (-(-M // bm), gy), smem(stages))


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
        ctypes.c_int] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int,
                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors on ``plan(M, N, K)``; returns
    (M,N) float32. Copies narrow to what each row stride and base pointer
    allow (``copy_widths``; a view at an odd offset takes byte copies)."""
    M, N, K = check_args(a, b, a_scale, b_scale)
    if a.device.type != "cuda":
        raise ValueError("int8_matmul kernel needs CUDA tensors")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    p = plan(M, N, K)
    if p.grid[0] > MAX_GRID_X or p.grid[1] > MAX_GRID_Y:
        raise ValueError(f"int8_matmul: {M}x{K}x{N} exceeds the kernel's "
                         "grid")
    a_vec, b_vec, out_vec = copy_widths(p.bn, K, N, a.data_ptr(),
                                        b.data_ptr(), out.data_ptr())
    with torch.cuda.device(a.device):
        code = _launcher()(a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                           b_scale.data_ptr(), out.data_ptr(), M, N, K, p.bn,
                           p.threads, p.stages, a_vec, b_vec, out_vec,
                           p.grid[0], p.grid[1], p.smem,
                           _build.stream_ptr(a))
    _build.check_launch("int8_matmul", code)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
