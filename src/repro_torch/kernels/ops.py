"""Public kernel API: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain version in ``ref``.

Counterpart of ``repro.kernels.ops``, without its tiling-contract fallbacks:
the CUDA kernels take every shape, and a CUDA input that a kernel does not
take raises. Arguments are validated the same way on both devices, so the
CPU tests exercise the checks the card relies on. Each kernel wrapper counts
its launches (``<module>.<function>.launches``).

Gradients: on CUDA, ``depthwise_conv3x3`` runs through the autograd
``Function`` whose backward is kernels too (f32). The other kernels have
no backward, and a kernel fills its output through a raw pointer, so the
result would carry no graph: on CUDA they raise when autograd would need
one, rather than silently drop the gradient. On the CPU every function is
its plain version, which autograd differentiates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"depthwise_conv3x3": _dw.depthwise_conv3x3,
           "depthwise_conv3x3_wgrad": _dw.depthwise_conv3x3_wgrad,
           "int8_matmul": _mm.int8_matmul,
           "quantize_rows": _q.quantize_rows,
           "flash_attention": _fa.flash_attention,
           "ssd_chunk_scan": _ssd.ssd_chunk_scan}
# the port's next slice, LM training, adds these kernels' backward
LM_BACKWARD = "yet (the LM-training slice adds it, ROADMAP Queue 1)"


def _on_cuda(t) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch kernels run on cuda or cpu, not "
                         f"{t.device}")
    return t.device.type == "cuda"


def _no_graph(name: str, why: str, *tensors) -> None:
    """Raise if autograd would need a graph through a CUDA kernel that has
    no backward (its result would come back detached)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} on CUDA has no backward kernel {why}, and an input "
            "requires grad: run it under torch.no_grad() or detach the "
            "inputs")


def int8_matmul(a, b, a_scale, b_scale):
    """(M,K) int8 x (K,N) int8 -> (M,N) f32 with per-row/column dequant."""
    if _on_cuda(a):
        _no_graph("int8_matmul", "(INT8 inference only)", a_scale, b_scale)
        return _mm.int8_matmul(a, b, a_scale, b_scale)
    _mm.check_args(a, b, a_scale, b_scale)
    return ref.int8_matmul(a, b, a_scale, b_scale)


def depthwise_conv3x3(x, w):
    """NHWC stride-1 SAME 3x3 depthwise; x (B,H,W,C), w (C,1,3,3).
    Differentiable on both devices; its backward on the card is f32."""
    if _on_cuda(x):
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad) \
                and x.dtype != torch.float32:
            raise NotImplementedError(
                f"depthwise_conv3x3: the backward kernels are float32 only, "
                f"got {x.dtype} under autograd")
        return _dw.DepthwiseConv3x3.apply(x, w)
    _dw.check_args(x, w)
    return ref.depthwise_conv3x3(x, w)


def depthwise_conv3x3_wgrad(x, g):
    """Weight gradient of ``depthwise_conv3x3``: x, g (B,H,W,C) f32 ->
    dw (C,1,3,3) f32."""
    if _on_cuda(x):
        return _dw.depthwise_conv3x3_wgrad(x, g)
    _dw.check_wgrad_args(x, g)
    return ref.depthwise_conv3x3_wgrad(x, g)


def quantize_rows(x):
    """(M,N) f32 -> (codes int8 (M,N), scales f32 (M,))."""
    if _on_cuda(x):
        _no_graph("quantize_rows", "(INT8 codes have no gradient)", x)
        return _q.quantize_rows(x)
    _q.check_args(x)
    return ref.quantize_rows(x)


def flash_attention(q, k, v, causal: bool = True):
    """Attention of q (B,H,S,D) over k, v (B,K,S,D), K dividing H; any S,
    strided views allowed. Returns (B,H,S,D) in q's dtype."""
    if _on_cuda(q):
        _no_graph("flash_attention", LM_BACKWARD, q, k, v)
        return _fa.flash_attention(q, k, v, causal)
    _fa.check_args(q, k, v)
    return ref.flash_attention(q, k, v, causal)


def ssd_chunk_scan(states, decay):
    """states (B,NC,H,P,N), decay (B,NC,H) -> the state before each chunk,
    (B,NC,H,P,N) in the states' dtype."""
    if _on_cuda(states):
        _no_graph("ssd_chunk_scan", LM_BACKWARD, states, decay)
        return _ssd.ssd_chunk_scan(states, decay)
    _ssd.check_args(states, decay)
    return ref.ssd_chunk_scan(states, decay)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
