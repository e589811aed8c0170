"""Causal / non-causal attention with an online softmax, on the card, and
its backward.

CUDA kernels ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``: scale 1/sqrt(D), fp32
running max, denominator and accumulator, causal mask -1e30, key tiles above
the diagonal skipped, output in q's dtype. Beyond the Pallas kernel, what
the reference model's attention adds for Gemma-2, Mixtral and Grok-1: a
sliding ``window`` (key j visible to query i iff j > i - window; tiles
wholly under it skipped) and a logit ``softcap`` (scores become softcap
tanh(score / softcap) before the mask), runtime arguments, 0 = off. The dtype picks the kernel: bf16
runs both products on the tensor cores (wgmma), rounding the probabilities
to bf16 before the PV product as the model's reference does; f32 runs fp32
FMAs on the CUDA cores. Both take what the Pallas kernel does not: any S
(no tiling contract), grouped-query k/v with fewer heads than q, and strided
(B,H,S,D) views such as the transpose of the model's seq-major (B,S,H,D)
projections. The kernels take the head dims of every config in the repo,
``HEAD_DIMS``; the plain version on the CPU takes any.

Training: ``FlashAttention`` is the autograd ``Function`` around the kernel.
Its forward also writes each query row's f32 log-sum-exp; its backward,
``flash_attention_bwd`` (no TPU counterpart: the reference's forward is jnp
code that XLA differentiates), is three launches of the same source
(delta = rowsum(dO o O), dK/dV per key tile, dQ per query tile), with no
atomics, so two calls give the same bits. The dtype picks the route as in
the forward: bf16 runs the dK/dV and dQ products on the tensor cores
(wgmma, P and dS rounded to bf16 as operands), f32 on the CUDA cores in
f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version also takes f64 (an f64 evaluation is the yardstick of
# the f32 ones); the kernels take ``_DTYPES``
_PLAIN_DTYPES = (*_DTYPES, torch.float64)
# the head dims the kernels are built for: those of every config in the
# repo (smoke 32; Llama, Whisper 64; Phi-3-vision 96; DeepSeek, Yi,
# Mixtral, Grok, Jamba 128; Gemma-2 256)
HEAD_DIMS = (32, 64, 96, 128, 256)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int = 0, softcap: float = 0.0
               ) -> Tuple[int, int, int, int, int]:
    """Validate q (B,H,S,D) and k, v (B,K,S,D) with K dividing H, one dtype
    (f32, bf16 or f64), one device, the last dim contiguous, an int
    ``window`` >= 0 and a finite ``softcap`` >= 0; returns (B, H, S, D,
    H // K). Raises on anything else. Any D and f64: the kernels' head dims
    and dtypes are checked by ``check_kernel_args``."""
    if isinstance(window, bool) or not isinstance(window, int) \
            or not 0 <= window < 2 ** 31:
        raise ValueError(f"flash_attention: window must be an int >= 0 "
                         f"(0 = off), got {window!r}")
    if not (isinstance(softcap, (int, float)) and math.isfinite(softcap)
            and softcap >= 0):
        raise ValueError(f"flash_attention: softcap must be a finite number "
                         f">= 0 (0 = off), got {softcap!r}")
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
    if q.dtype not in _PLAIN_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32, "
                        f"bfloat16 or float64, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    return B, H, S, D, H // K


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0, softcap: float = 0.0
                      ) -> Tuple[int, int, int, int, int]:
    """``check_args``, then what the kernels add: CUDA tensors in f32 or
    bf16, a head dim in ``HEAD_DIMS`` and a grid the card can launch."""
    B, H, S, D, G = check_args(q, k, v, window, softcap)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in the "
                         f"kernels' {HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if H > 65535 or B > 65535 or -(-S // 32) > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H}, S={S} exceed the "
                         "kernel's grid")
    return B, H, S, D, G


def _misaligned(t: torch.Tensor) -> bool:
    """Whether a bf16 kernel's 16-byte row loads cannot read ``t``: its base
    pointer or a (batch, head, seq) stride is not 16-byte aligned."""
    return t.dtype == torch.bfloat16 and bool(
        t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)))


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    if any(map(_misaligned, ts)):
        raise ValueError(f"{name}: the bf16 kernels load 16-byte rows: base "
                         "pointers and (batch, head, seq) strides must be "
                         "16-byte aligned")


def _strides(*ts) -> ctypes.Array:
    return (ctypes.c_int64 * (3 * len(ts)))(*(t.stride(i) for t in ts
                                               for i in range(3)))


def _seq_major(B: int, S: int, H: int, D: int, like: torch.Tensor
               ) -> torch.Tensor:
    """An empty (B,H,S,D) view of a contiguous (B,S,H,D) tensor, the layout
    of the model's projections."""
    return torch.empty((B, S, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = _build.library("flash_attention").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 5
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, with_lse: bool = False,
                    window: int = 0, softcap: float = 0.0):
    """Launch the kernel on CUDA tensors. Returns (B,H,S,D) in q's dtype,
    a view of a (B,S,H,D) contiguous tensor, so ``out.transpose(1, 2)``
    is the model's seq-major layout without a copy; with ``with_lse`` also
    the f32 log-sum-exp of each query row's scaled (capped, masked) scores,
    (B,H,S) (else the kernel is given a null pointer and writes none).
    ``window`` > 0: the sliding window; ``softcap`` > 0: the logit softcap
    (``ref.flash_attention``)."""
    B, H, S, D, G = check_kernel_args(q, k, v, window, softcap)
    _check_aligned("flash_attention", q, k, v)
    o = _seq_major(B, S, H, D, q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    with torch.cuda.device(q.device):
        code = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), None if lse is None
                           else lse.data_ptr(), B, H, S, D, G, int(causal),
                           window, float(softcap), 1.0 / math.sqrt(D),
                           _strides(q, k, v, o),
                           _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check_launch("flash_attention", code)
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


flash_attention.launches = 0


def check_bwd_args(q, k, v, o, lse, do, window: int = 0,
                   softcap: float = 0.0) -> Tuple[int, int, int, int, int]:
    """Validate the backward's inputs: q, k, v, window and softcap as the
    forward takes them, o and do (B,H,S,D) in q's dtype with the head dim
    contiguous, lse (B,H,S) f32 contiguous (f64 for f64 q), all on one
    device."""
    B, H, S, D, G = check_args(q, k, v, window, softcap)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_bwd: {name}'s head dim must "
                             "be contiguous")
    lse_dt = torch.promote_types(q.dtype, torch.float32)
    if tuple(lse.shape) != (B, H, S) or lse.dtype != lse_dt \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"({B},{H},{S}) {lse_dt}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: inputs on different devices")
    return B, H, S, D, G


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention`` for the output
    gradient ``do``, from the forward's ``o`` and ``lse`` (with the same
    ``causal``, ``window`` and ``softcap``): three launches on
    CUDA tensors, in q's dtype, each a view of a seq-major contiguous
    tensor as the forward's output is. bf16 runs dK/dV and dQ on the
    tensor cores, rounding P and dS to bf16 before their products (f32
    scores, delta and sums): q, k, v, o and do must be 16-byte aligned as
    for the bf16 forward. f32 runs them on the CUDA cores in f32."""
    check_kernel_args(q, k, v, window, softcap)
    B, H, S, D, G = check_bwd_args(q, k, v, o, lse, do, window, softcap)
    _check_aligned("flash_attention_bwd", q, k, v, o, do)
    dq = _seq_major(B, S, H, D, q)
    dk = _seq_major(B, S, H // G, D, q)
    dv = _seq_major(B, S, H // G, D, q)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, S, D, G, int(causal),
            window, float(softcap), 1.0 / math.sqrt(D),
            _strides(q, k, v, o, do, dq, dk, dv),
            _DTYPES[q.dtype], _build.stream_ptr(q))
    _build.check_launch("flash_attention", code)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The attention kernel with its backward on kernels too: the forward
    saves its output and log-sum-exp, the backward is
    ``flash_attention_bwd``. An output gradient whose head dim is not
    contiguous, or that the bf16 kernels cannot read in 16-byte rows, is
    copied first."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int = 0,
                softcap: float = 0.0):
        o, lse = flash_attention(q, k, v, causal, with_lse=True,
                                 window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return o

    @staticmethod
    def backward(ctx, do) -> Tuple[Optional[torch.Tensor], ...]:
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or _misaligned(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.window, ctx.softcap)
        return dq, dk, dv, None, None, None
