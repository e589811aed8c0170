"""Public kernel API: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain version in ``ref``.

Counterpart of ``repro.kernels.ops``, without its tiling-contract fallbacks:
the CUDA kernels take every shape, and a CUDA input that a kernel does not
take raises. Arguments are validated the same way on both devices, so the
CPU tests exercise the checks the card relies on. Each kernel wrapper counts
its launches (``<module>.<function>.launches``).

Gradients: on CUDA, ``depthwise_conv3x3``, ``flash_attention`` and
``ssd_chunk_scan`` run through autograd ``Function``s whose backward is
kernels too (``flash_attention_bwd``, ``ssd_chunk_scan_bwd``; the depthwise
backward in f32). The INT8 kernels have no backward, and a kernel fills its
output through a raw pointer, so the result would carry no graph: on CUDA
they raise when autograd would need one, rather than silently drop the
gradient. On the CPU every function is its plain version, which autograd
differentiates.

A ``meta`` tensor (the dry-run's) goes to ``kernels.meta``: the kernels'
output shapes and their cost, no data. Only meta takes that route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"depthwise_conv3x3": _dw.depthwise_conv3x3,
           "depthwise_conv3x3_wgrad": _dw.depthwise_conv3x3_wgrad,
           "int8_matmul": _mm.int8_matmul,
           "quantize_rows": _q.quantize_rows,
           "flash_attention": _fa.flash_attention,
           "flash_attention_bwd": _fa.flash_attention_bwd,
           "ssd_chunk_scan": _ssd.ssd_chunk_scan,
           "ssd_chunk_scan_bwd": _ssd.ssd_chunk_scan_bwd}


def _on_cuda(t) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch kernels run on cuda or cpu, not "
                         f"{t.device}")
    return t.device.type == "cuda"


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_graph(name: str, why: str, *tensors) -> None:
    """Raise if autograd would need a graph through a CUDA kernel that has
    no backward (its result would come back detached)."""
    if _needs_graph(*tensors):
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


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """Attention of q (B,H,S,D) over k, v (B,K,S,D), K dividing H; any S,
    strided views allowed; ``window`` > 0 a sliding window, ``softcap`` > 0
    the logit softcap (0 = off). Returns (B,H,S,D) in q's dtype. On CUDA
    under autograd it runs through ``FlashAttention`` (the forward also
    writes the log-sum-exp the backward reads); otherwise the forward kernel
    alone."""
    if q.device.type == "meta":
        return _meta.flash_attention(q, k, v, causal, window, softcap)
    if _on_cuda(q):
        if _needs_graph(q, k, v):
            return _fa.FlashAttention.apply(q, k, v, causal, window, softcap)
        return _fa.flash_attention(q, k, v, causal, window=window,
                                   softcap=softcap)
    _fa.check_args(q, k, v, window, softcap)
    return ref.flash_attention(q, k, v, causal, window, softcap)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention`` from its output ``o``, the
    log-sum-exp ``lse`` (B,H,S) f32 and the output gradient ``do``."""
    if _on_cuda(q):
        return _fa.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                       softcap)
    _fa.check_bwd_args(q, k, v, o, lse, do, window, softcap)
    return ref.flash_attention_bwd(q, k, v, o, lse, do, causal, window,
                                   softcap)


def ssd_chunk_scan(states, decay):
    """states (B,NC,H,P,N), decay (B,NC,H) -> the state before each chunk,
    (B,NC,H,P,N) in the states' dtype. On CUDA under autograd it runs
    through ``SsdChunkScan``."""
    if states.device.type == "meta":
        return _meta.ssd_chunk_scan(states, decay)
    if _on_cuda(states):
        if _needs_graph(states, decay):
            return _ssd.SsdChunkScan.apply(states, decay)
        return _ssd.ssd_chunk_scan(states, decay)
    _ssd.check_args(states, decay)
    return ref.ssd_chunk_scan(states, decay)


def ssd_chunk_scan_bwd(g, out, decay):
    """(dstates, ddecay) of ``ssd_chunk_scan`` for the output gradient g,
    from its output ``out``."""
    if _on_cuda(g):
        return _ssd.ssd_chunk_scan_bwd(g, out, decay)
    _ssd.check_bwd_args(g, out, decay)
    return ref.ssd_chunk_scan_bwd(g, out, decay)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
