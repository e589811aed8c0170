"""The kernels on ``meta`` tensors: shapes and a cost tally, no data.

The dry-run (``launch.dryrun``) traces whole training, prefill and decode
steps on meta tensors, where no kernel and no plain version can run. Here
each of the two LM kernels is an autograd ``Function`` whose forward and
backward return empty tensors of the kernel's output shapes (the plain
versions' shape arithmetic), and report the kernel's own work to
``counter`` (when set): its operations, counting the (query, key) pairs
the kernel visits (the causal triangle, the sliding window's band), not
the plain version's dense S x S, and its bytes, each input read once and
each output written once. Each allocates, in the card's layouts, and
saves for its backward the tensors the card's wrapper does (the outputs
as views of seq-major tensors, the forward's log-sum-exp, the backward's
delta and partial sums), so the dry-run's activation peak sees the card's
route. ``kernels.ops`` routes a meta tensor here and nothing
else: a CUDA tensor always goes to its kernel.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd

# counter(name, operations, bytes): called once per kernel launch traced
counter: Optional[Callable[[str, float, float], None]] = None


def _count(name: str, ops: float, nbytes: float) -> None:
    if counter is not None:
        counter(name, float(ops), float(nbytes))


def _bytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(S: int, window: int, causal: bool) -> int:
    """(query, key) pairs the flash kernels visit for one head: causal,
    the sum over rows of min(q + 1, window) (window 0: the triangle);
    non-causal, S^2 less the keys a window hides."""
    if causal:
        if window <= 0 or window >= S:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    if window <= 0 or window >= S:
        return S * S
    return S * S - (S - window) * (S - window + 1) // 2


class FlashAttention(torch.autograd.Function):
    """Meta twin of ``flash_attention.FlashAttention``: 4 operations per
    visible pair and head dim forward (QK^T, PV), 10 backward (S and dP
    recomputed, dV, dK, dQ), as ``chip_smoke.py`` bounds the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int = 0,
                softcap: float = 0.0):
        B, H, S, D, _ = _fa.check_args(q, k, v, window, softcap)
        o = _fa._seq_major(B, S, H, D, q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        pairs = B * H * visible_pairs(S, window, causal)
        _count("flash_attention", 4 * D * pairs, _bytes(q, k, v, o))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.pairs = pairs
        return o

    @staticmethod
    def backward(ctx, do) -> Tuple[Optional[torch.Tensor], ...]:
        q, k, v, _, lse = ctx.saved_tensors
        B, H, S, D = q.shape
        K = k.shape[1]
        dq, dk, dv = (_fa._seq_major(B, S, h, D, q) for h in (H, K, K))
        delta = torch.empty_like(lse)
        o_and_lse = _bytes(do) + _bytes(delta)
        _count("flash_attention_bwd", 10 * q.shape[3] * ctx.pairs,
               _bytes(q, k, v, do, dq, dk, dv) + o_and_lse)
        return dq, dk, dv, None, None, None


class SsdChunkScan(torch.autograd.Function):
    """Meta twin of ``ssd_scan.SsdChunkScan``: 2 operations per state
    element forward (s * decay + states), 4 backward (the reverse scan and
    the decay's gradient)."""

    @staticmethod
    def forward(ctx, states, decay):
        _ssd.check_args(states, decay)
        out = torch.empty(states.shape, dtype=states.dtype,
                          device=states.device)
        _count("ssd_chunk_scan", 2 * states.numel(),
               _bytes(states, decay, out))
        ctx.save_for_backward(out, decay)
        return out

    @staticmethod
    def backward(ctx, g):
        out, decay = ctx.saved_tensors
        B, NC, H, P, N = out.shape
        ds = torch.empty(out.shape, dtype=g.dtype, device=g.device)
        dd = torch.empty(decay.shape, dtype=torch.float32, device=g.device)
        partial = torch.empty((B, NC, H, -(-P * N // _ssd.BWD_THREADS)),
                              dtype=torch.float32, device=g.device)
        _count("ssd_chunk_scan_bwd", 4 * out.numel(),
               _bytes(g, out, decay, ds) + decay.numel() * 4)
        del partial
        return ds, dd if ctx.needs_input_grad[1] else None


def flash_attention(q, k, v, causal: bool, window: int, softcap: float):
    return FlashAttention.apply(q, k, v, causal, window, softcap)


def ssd_chunk_scan(states, decay):
    return SsdChunkScan.apply(states, decay)
