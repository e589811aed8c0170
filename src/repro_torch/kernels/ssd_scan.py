"""Mamba-2 SSD inter-chunk state scan, on the card.

CUDA kernel ``csrc/ssd_scan.cu``, the port of the Pallas kernel
``repro.kernels.ssd_scan.ssd_chunk_scan``: for states (B,NC,H,P,N) and
float32 decay (B,NC,H), ``s_0 = 0, s_{c+1} = s_c * decay_c + states_c``,
returning s_c for every chunk, fp32 carry, in the states' dtype. Any shape and any
strides; the output is contiguous.

Training: ``SsdChunkScan`` is the autograd ``Function`` around the kernel;
its backward, ``ssd_chunk_scan_bwd`` (no TPU counterpart), is the reverse
scan of the same source: lam_c = g_c + lam_{c+1} decay_c with an f32 carry,
dstates_c = lam_{c+1}, ddecay_c = sum_{p,n} lam_{c+1} s_c from the saved
output s, summed in a fixed order (no atomics).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(states: torch.Tensor, decay: torch.Tensor
               ) -> Tuple[int, int, int, int, int]:
    """Validate states (B,NC,H,P,N), float32 or bfloat16, and float32
    decay (B,NC,H) (the model's ``exp`` of its f32 chunk sums), on one
    device; returns (B, NC, H, P, N). The plain version also takes f64
    states with f64 decay (an f64 evaluation is the yardstick of the f32
    ones); ``check_kernel_args`` refuses them."""
    if states.dim() != 5:
        raise ValueError(f"ssd_chunk_scan: states must be (B,NC,H,P,N), got "
                         f"{tuple(states.shape)}")
    B, NC, H, P, N = states.shape
    if tuple(decay.shape) != (B, NC, H):
        raise ValueError(f"ssd_chunk_scan: decay must be ({B},{NC},{H}), "
                         f"got {tuple(decay.shape)}")
    f64 = states.dtype == decay.dtype == torch.float64
    if not f64 and (states.dtype not in _DTYPES
                    or decay.dtype != torch.float32):
        raise TypeError(f"ssd_chunk_scan: states must be float32 or "
                        f"bfloat16 and decay float32 (or both float64), got "
                        f"{states.dtype}, {decay.dtype}")
    if decay.device != states.device:
        raise ValueError("ssd_chunk_scan: states and decay on different "
                         "devices")
    return B, NC, H, P, N


def check_kernel_args(states: torch.Tensor, decay: torch.Tensor
                      ) -> Tuple[int, int, int, int, int]:
    """``check_args``, then what the kernels add: CUDA tensors, states in
    f32 or bf16 and a grid the card can launch."""
    B, NC, H, P, N = check_args(states, decay)
    if states.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk_scan: the kernels take float32 or "
                        f"bfloat16 states, got {states.dtype}")
    if states.device.type != "cuda":
        raise ValueError("ssd_chunk_scan kernel needs CUDA tensors")
    if H > 65535 or B > 65535 or P * N >= 2 ** 31:
        raise ValueError(f"ssd_chunk_scan: {tuple(states.shape)} exceeds "
                         "the kernel's grid")
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
    B, NC, H, P, N = check_kernel_args(states, decay)
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


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.library("ssd_scan").ssd_chunk_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


BWD_THREADS = 256              # the backward kernel's block: (p, n) a block


def check_bwd_args(g: torch.Tensor, out: torch.Tensor, decay: torch.Tensor
                   ) -> Tuple[int, int, int, int, int]:
    """Validate the backward's inputs: the output gradient g and the
    forward's output ``out``, (B,NC,H,P,N) in one dtype (``out``
    contiguous), and decay as the forward takes it."""
    B, NC, H, P, N = check_args(g, decay)
    if tuple(out.shape) != tuple(g.shape) or out.dtype != g.dtype \
            or not out.is_contiguous() or out.device != g.device:
        raise ValueError(f"ssd_chunk_scan_bwd: out must be contiguous "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    return B, NC, H, P, N


def ssd_chunk_scan_bwd(g: torch.Tensor, out: torch.Tensor,
                       decay: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dstates in g's dtype, ddecay f32) of
    ``ssd_chunk_scan`` for the output gradient ``g``, from the forward's
    output: two launches on CUDA tensors, both results contiguous."""
    check_kernel_args(g, decay)
    B, NC, H, P, N = check_bwd_args(g, out, decay)
    dstates = torch.empty((B, NC, H, P, N), dtype=g.dtype, device=g.device)
    ddecay = torch.empty((B, NC, H), dtype=torch.float32, device=g.device)
    if dstates.numel() == 0:
        return dstates, ddecay.zero_()
    nblk = -(-P * N // BWD_THREADS)
    partial = torch.empty((B, NC, H, nblk), dtype=torch.float32,
                          device=g.device)
    strides = (ctypes.c_int64 * 8)(*g.stride(), *decay.stride())
    with torch.cuda.device(g.device):
        code = _bwd_launcher()(g.data_ptr(), out.data_ptr(), decay.data_ptr(),
                               dstates.data_ptr(), ddecay.data_ptr(),
                               partial.data_ptr(), B, NC, H, P, N, strides,
                               _DTYPES[g.dtype], _build.stream_ptr(g))
    _build.check_launch("ssd_scan", code)
    ssd_chunk_scan_bwd.launches += 1
    return dstates, ddecay


ssd_chunk_scan_bwd.launches = 0


class SsdChunkScan(torch.autograd.Function):
    """The scan kernel with its backward on kernels too: the forward saves
    its output and the decay, the backward is ``ssd_chunk_scan_bwd``."""

    @staticmethod
    def forward(ctx, states, decay):
        out = ssd_chunk_scan(states, decay)
        ctx.save_for_backward(out, decay)
        return out

    @staticmethod
    def backward(ctx, g) -> Tuple[Optional[torch.Tensor], ...]:
        out, decay = ctx.saved_tensors
        dstates, ddecay = ssd_chunk_scan_bwd(g, out, decay)
        return dstates, ddecay if ctx.needs_input_grad[1] else None
