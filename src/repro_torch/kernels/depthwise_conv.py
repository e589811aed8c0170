"""Depthwise 3x3 conv on the card (the IRB hot path of the paper's networks).

CUDA kernel ``csrc/depthwise_conv.cu``, the port of the Pallas kernel
``repro.kernels.depthwise_conv.depthwise_conv3x3_padded``: NHWC, stride 1,
SAME padding, fp32 accumulation, output in the input dtype (f32 or bf16).
It takes any B, H, W and C: there is no tiling contract and no fallback.
``plan`` picks the kernel's tile for each layer shape.

Training (f32): ``DepthwiseConv3x3`` is the autograd ``Function`` around
the kernel. Its input gradient is the same forward kernel run on the
output gradient with the weights turned 180 degrees; its weight gradient
is ``depthwise_conv3x3_wgrad``, a second kernel of the same source (no TPU
counterpart: the reference lets XLA transpose ``lax.conv``). It is one
launch a call: blocks stage tiles of x and g in shared memory, a
thread-block cluster sums its blocks' partials through distributed shared
memory, and where several clusters share a channel chunk a ticketed last
block sums their rows, all in a fixed order with no float atomics, so two
calls give the same bits. ``wgrad_plan`` picks its layout and the bound
on its rounding (``WgradPlan.depth``); the tickets and rows live in a
workspace kept per device and stream, so a call allocates nothing but dw.
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


# -- weight gradient --------------------------------------------------------

WGRAD_FILL = SMS           # blocks wanted: one an SM, where the map has them
WGRAD_BLOCKS = 2 * SMS     # at most one wave of two blocks an SM (two stages
                           # of the largest tile take 77 KB of shared memory)
WGRAD_MAX_TH = 8           # tile rows, at most
WGRAD_MAX_TW = 16          # tile columns, at most (and MAX_THREADS // cg_blk)
CLUSTER_ONE = 16           # a cluster that covers its chunk alone, at most
                           # (non-portable above 8; blocks of one tile each)
CLUSTER_MANY = 8           # a cluster among several of a chunk, or of blocks
                           # that walk several tiles, at most (portable)


class WgradPlan(NamedTuple):
    """The weight-gradient kernel's layout for one (B, H, W, C): tiles of
    ``th`` rows x ``tw`` columns of one image (``n_tiles`` a chunk:
    ``n_strips`` x ``n_segs`` per image); ``n_chunks`` chunks of ``cg_blk``
    channel groups (4 channels each); per chunk ``n_clusters`` clusters of
    ``cluster`` blocks, block bx taking tiles bx, bx + nbx, ... (at most
    ``per_thread``), with ``stages`` tiles staged at once. ``depth`` bounds
    the roundings any one product goes through on its way into dw: the
    thread's chain (per_thread x th), then the block's tw columns, the
    cluster's ranks and the chunk's rows, each summed in order."""
    th: int
    tw: int
    cg_blk: int
    n_chunks: int
    n_strips: int
    n_segs: int
    n_tiles: int
    cluster: int
    n_clusters: int
    per_thread: int
    stages: int
    depth: int

    @property
    def nbx(self) -> int:
        """Blocks a chunk."""
        return self.cluster * self.n_clusters

    @property
    def blocks(self) -> int:
        return self.nbx * self.n_chunks

    @property
    def threads(self) -> int:
        return self.cg_blk * self.tw


@functools.lru_cache(maxsize=1024)
def wgrad_plan(B: int, H: int, W: int, C: int) -> WgradPlan:
    """Channel chunks as ``plan`` cuts them. Columns: the fewest equal
    segments of at most WGRAD_MAX_TW (and MAX_THREADS // cg_blk). Rows:
    the largest power of two up to WGRAD_MAX_TH that is at most H, halved
    while the chunks' tiles give fewer than WGRAD_FILL blocks. Blocks: one
    tile each where all tiles fit WGRAD_BLOCKS, else each the same number
    of tiles, as few as keep the blocks within WGRAD_BLOCKS. Clusters: one
    a chunk where its blocks, of one tile each, are at most CLUSTER_ONE;
    else the fewest of at most CLUSTER_MANY, of equal size."""
    p = plan(B, H, W, C)
    n_segs = -(-W // min(WGRAD_MAX_TW, MAX_THREADS // p.cg_blk))
    tw = -(-W // n_segs)
    th = 1
    while th * 2 <= min(H, WGRAD_MAX_TH):
        th *= 2

    def tiles(rows):
        return B * -(-H // rows) * n_segs
    while th > 1 and p.n_chunks * tiles(th) < WGRAD_FILL:
        th //= 2
    n_tiles = tiles(th)
    per = -(-n_tiles // max(1, WGRAD_BLOCKS // p.n_chunks))
    nbx = -(-n_tiles // per)
    if per == 1 and nbx <= CLUSTER_ONE:
        cluster, n_clusters = nbx, 1
    else:
        n_clusters = -(-nbx // CLUSTER_MANY)
        cluster = -(-nbx // n_clusters)
    per = -(-n_tiles // (cluster * n_clusters))
    depth = per * th + tw - 1 + cluster - 1 + n_clusters - 1
    return WgradPlan(th, tw, p.cg_blk, p.n_chunks, -(-H // th), n_segs,
                     n_tiles, cluster, n_clusters, per, min(per, 2), depth)


def check_wgrad_args(x: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[int, int, int, int]:
    """Validate (x, g both (B,H,W,C) contiguous float32 on one device);
    returns (B, H, W, C). The weight gradient is f32 only: the XR nets
    train in f32."""
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"depthwise_conv3x3_wgrad: x and g must both be "
                         f"(B,H,W,C), got {tuple(x.shape)} and "
                         f"{tuple(g.shape)}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"depthwise_conv3x3_wgrad: float32 only, got "
                        f"{x.dtype} and {g.dtype}")
    if g.device != x.device:
        raise ValueError("depthwise_conv3x3_wgrad: x and g on different "
                         "devices")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("depthwise_conv3x3_wgrad: x and g must be "
                         "contiguous NHWC")
    return tuple(x.shape)


@functools.lru_cache(maxsize=None)
def _wgrad_launcher():
    fn = _build.library("depthwise_conv").depthwise_conv3x3_wgrad_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# (device index, stream handle) -> (tickets, rows): the counters that pick
# the block summing a share of a chunk's rows, zeroed once here and left at
# zero by every launch, and the rows, written before they are read in each
# launch. One pair per stream, so that launches on two streams never share
# a counter (csrc/depthwise_conv.cu explains why none is left dirty).
_WORKSPACE = {}


def _workspace(device, stream: int, n_tickets: int, n_rows: int):
    tickets, rows = _WORKSPACE.get((device.index, stream), (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if rows is None or rows.numel() < n_rows:
        rows = torch.empty(n_rows, dtype=torch.float32, device=device)
    _WORKSPACE[(device.index, stream)] = tickets, rows
    return tickets, rows


def depthwise_conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the weight-gradient kernel on CUDA tensors x, g (B,H,W,C)
    f32: dw (C,1,3,3) f32, the same bits on every run."""
    B, H, W, C = check_wgrad_args(x, g)
    if x.device.type != "cuda":
        raise ValueError("depthwise_conv3x3_wgrad kernel needs CUDA tensors")
    dw = torch.empty((C, 1, 3, 3), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    p = wgrad_plan(B, H, W, C)
    if p.n_tiles + p.nbx > 2 ** 31 - 1 or p.n_chunks > 65535:
        raise ValueError(f"depthwise_conv3x3_wgrad: {B}x{H}x{W}x{C} exceeds "
                         "the kernel's 32-bit indices or grid")
    vec = C % 4 == 0 and x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = rows = 0
        if p.n_clusters > 1:
            t, r = _workspace(x.device, stream, p.n_chunks * p.cluster,
                              p.n_chunks * p.n_clusters * p.cg_blk * 36)
            tickets, rows = t.data_ptr(), r.data_ptr()
        code = _wgrad_launcher()(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                                 rows, tickets, B, H, W, C, p.th, p.tw,
                                 p.cg_blk, p.n_chunks, p.cluster,
                                 p.n_clusters, p.stages, int(vec), stream)
    _build.check_launch("depthwise_conv", code)
    depthwise_conv3x3_wgrad.launches += 1
    return dw


depthwise_conv3x3_wgrad.launches = 0


def wgrad_clusters_held(B: int, H: int, W: int, C: int) -> int:
    """How many clusters of ``wgrad_plan``'s launch for (B, H, W, C) the
    current card holds at once (cudaOccupancyMaxActiveClusters): the plan
    makes one wave where its ``n_chunks * n_clusters`` are at most that."""
    p = wgrad_plan(B, H, W, C)
    fn = _build.library("depthwise_conv").depthwise_conv3x3_wgrad_max_clusters
    fn.argtypes = [ctypes.c_int64] * 4 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    _build.check_launch("depthwise_conv", fn(
        B, H, W, C, p.th, p.tw, p.cg_blk, p.n_chunks, p.cluster,
        p.n_clusters, p.stages, int(C % 4 == 0), ctypes.byref(out)))
    return out.value

def rotated(w: torch.Tensor) -> torch.Tensor:
    """(C,1,3,3) weights turned 180 degrees: the forward on the output
    gradient with them is the input gradient (stride 1, SAME padding)."""
    return w.flip((-1, -2)).contiguous()


class DepthwiseConv3x3(torch.autograd.Function):
    """The depthwise kernel with its backward on kernels too: the input
    gradient from ``depthwise_conv3x3`` on the output gradient with
    ``rotated`` weights, the weight gradient from ``depthwise_conv3x3_wgrad``.
    The output gradient is made contiguous NHWC first; the model keeps its
    ops channels_last, so there that is no copy (``copies`` counts the
    backward calls that had to copy)."""
    copies = 0

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_conv3x3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if not g.is_contiguous():
            DepthwiseConv3x3.copies += 1
            g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv3x3(g, rotated(w))
        if ctx.needs_input_grad[1]:
            dw = depthwise_conv3x3_wgrad(x, g)
        return dx, dw
