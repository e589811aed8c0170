"""Public kernel API: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain version in ``ref``.

Counterpart of ``repro.kernels.ops``, without its tiling-contract fallbacks:
the CUDA kernels take every shape, and a CUDA input that a kernel does not
take raises. Arguments are validated the same way on both devices, so the
CPU tests exercise the checks the card relies on. Each kernel wrapper counts
its launches (``<module>.<function>.launches``).
"""
from __future__ import annotations

from repro_torch.kernels import depthwise_conv as _dw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int8_matmul as _mm
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {"depthwise_conv3x3": _dw.depthwise_conv3x3,
           "int8_matmul": _mm.int8_matmul,
           "quantize_rows": _q.quantize_rows,
           "flash_attention": _fa.flash_attention,
           "ssd_chunk_scan": _ssd.ssd_chunk_scan}


def _on_cuda(t) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch kernels run on cuda or cpu, not "
                         f"{t.device}")
    return t.device.type == "cuda"


def int8_matmul(a, b, a_scale, b_scale):
    """(M,K) int8 x (K,N) int8 -> (M,N) f32 with per-row/column dequant."""
    if _on_cuda(a):
        return _mm.int8_matmul(a, b, a_scale, b_scale)
    _mm.check_args(a, b, a_scale, b_scale)
    return ref.int8_matmul(a, b, a_scale, b_scale)


def depthwise_conv3x3(x, w):
    """NHWC stride-1 SAME 3x3 depthwise; x (B,H,W,C), w (C,1,3,3)."""
    if _on_cuda(x):
        return _dw.depthwise_conv3x3(x, w)
    _dw.check_args(x, w)
    return ref.depthwise_conv3x3(x, w)


def quantize_rows(x):
    """(M,N) f32 -> (codes int8 (M,N), scales f32 (M,))."""
    if _on_cuda(x):
        return _q.quantize_rows(x)
    _q.check_args(x)
    return ref.quantize_rows(x)


def flash_attention(q, k, v, causal: bool = True):
    """Attention of q (B,H,S,D) over k, v (B,K,S,D), K dividing H; any S,
    strided views allowed. Returns (B,H,S,D) in q's dtype."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal)
    _fa.check_args(q, k, v)
    return ref.flash_attention(q, k, v, causal)


def ssd_chunk_scan(states, decay):
    """states (B,NC,H,P,N), decay (B,NC,H) -> the state before each chunk,
    (B,NC,H,P,N) in the states' dtype."""
    if _on_cuda(states):
        return _ssd.ssd_chunk_scan(states, decay)
    _ssd.check_args(states, decay)
    return ref.ssd_chunk_scan(states, decay)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
