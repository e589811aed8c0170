"""Depthwise 3x3 conv on the card (the IRB hot path of the paper's networks).

CUDA kernel ``csrc/depthwise_conv.cu``, the port of the Pallas kernel
``repro.kernels.depthwise_conv.depthwise_conv3x3_padded``: NHWC, stride 1,
SAME padding, fp32 accumulation, output in the input dtype (f32 or bf16).
It takes any B, H, W and C: there is no tiling contract and no fallback.
``plan`` picks the kernel's tile for each layer shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                      # H100 SXM streaming multiprocessors
# At most 8 channel groups (32 channels) a block, so a block spans 16
# neighbouring output columns, whose shared inputs and weights stay in L1:
# 16, 32, 64 and 128 groups measured slower on the H100, 4 and 2 too
MAX_CG_BLK = 8
MAX_THREADS = 128              # the kernel's __launch_bounds__
MAX_TH = 8                     # output rows per thread, at most


class Plan(NamedTuple):
    """The kernel's tile for one (B, H, W, C): ``th`` output rows per
    thread; blocks of ``cg_blk`` channel groups (4 channels each) x ``upb``
    output columns, ``n_chunks`` blocks across the channel groups and
    ``blocks`` in all. A column ("unit") is one (image, row strip, column)
    of the batch, so a small map fills a block with many images' columns."""
    th: int
    cg_blk: int
    upb: int
    n_chunks: int
    n_units: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def plan(B: int, H: int, W: int, C: int) -> Plan:
    """Tile for a (B,H,W,C) layer. Channel groups split into the fewest
    equal chunks of at most MAX_CG_BLK; columns per block (at most
    MAX_THREADS threads) leave the fewest idle lanes in the block's last
    warp, then are the most; rows per thread from MAX_TH down to 2 until
    the grid has two waves of blocks on the card's SMs (or th reaches 2)."""
    cg = -(-C // 4)
    n_chunks = -(-cg // MAX_CG_BLK)
    cg_blk = -(-cg // n_chunks)

    def waste(u):                             # idle lanes of the last warp
        lanes = -(-cg_blk * u // 32) * 32
        return (lanes - cg_blk * u) / lanes, -u
    upb = min(range(1, MAX_THREADS // cg_blk + 1), key=waste)

    def at(th):
        n_units = B * -(-H // th) * W
        return Plan(th, cg_blk, upb, n_chunks, n_units,
                    -(-n_units // upb) * n_chunks)
    th = MAX_TH
    while th > 2 and (th > H or at(th).blocks < 2 * SMS):
        th //= 2
    return at(th)


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
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors x (B,H,W,C), w (C,1,3,3)."""
    B, H, W, C = check_args(x, w)
    if x.device.type != "cuda":
        raise ValueError("depthwise_conv3x3 kernel needs CUDA tensors")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = plan(B, H, W, C)
    if p.n_units > 2 ** 31 - 1 or H * W * C > 2 ** 31 - 1 \
            or p.n_chunks > 65535:
        raise ValueError(f"depthwise_conv3x3: {B}x{H}x{W}x{C} exceeds the "
                         "kernel's 32-bit indices or grid")
    vec = C % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                             for t in (x, w, y))
    with torch.cuda.device(x.device):
        code = _launcher()(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                           B, H, W, C, p.th, p.cg_blk, p.upb, p.n_chunks,
                           int(vec), _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check_launch("depthwise_conv", code)
    depthwise_conv3x3.launches += 1
    return y


depthwise_conv3x3.launches = 0
