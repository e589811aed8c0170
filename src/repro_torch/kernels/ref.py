"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, in the same order of
arithmetic where that fixes the bits. The CPU path of ``kernels.ops`` runs
them, the CPU tests hold them against ``repro.kernels.ref``, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
Counterpart of ``repro.kernels.ref`` (int8_matmul, depthwise_conv3x3,
flash_attention, ssd_chunk_scan, quantize_rows), plus the backward pieces
the reference leaves to XLA: the depthwise convolution's weight gradient,
the attention's backward and the scan's.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim f32 tensor on ``like``'s device. Dividing by it is a
    true division everywhere; a Python float divisor on a CUDA tensor
    becomes a multiply by its reciprocal, which can move a .5 tie."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def int8_matmul(a: torch.Tensor, b: torch.Tensor, a_scale: torch.Tensor,
                b_scale: torch.Tensor) -> torch.Tensor:
    """(M,K) int8 x (K,N) int8 -> (M,N) f32, int32 accumulation, then
    ``(f32(acc) * a_scale[:, None]) * b_scale[None, :]``.

    The sum runs in float64, whose products and sums of int8 values are
    exact integers for any K the int32 accumulator can hold (CUDA has no
    int32 matmul); it is then taken to int32 and converted as the kernel
    converts its accumulator."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    acc = acc.to(torch.int32)
    return acc.to(torch.float32) * a_scale[:, None] * b_scale[None, :]


def depthwise_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC depthwise 3x3, stride 1, SAME padding; x: (B,H,W,C), w: (C,1,3,3)
    (the model's layout). Nine shifted multiply-adds in fp32, in the
    kernel's tap order; output in x's dtype."""
    B, H, W, C = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    taps = w.to(torch.float32).reshape(C, 9)
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc = acc + xp[:, di:di + H, dj:dj + W, :] * taps[:, 3 * di + dj]
    return acc.to(x.dtype)


def depthwise_conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``depthwise_conv3x3`` at input x (B,H,W,C) for
    the output gradient g (B,H,W,C): (C,1,3,3),

        dw[c, 0, di, dj] = sum_{b,h,w} xpad[b, h+di, w+dj, c] g[b, h, w, c],

    xpad the input with one zero row and column on each side; each tap a
    sum in f32 (in f64 for f64 inputs), in PyTorch's order, not the
    kernel's. The input gradient needs no function of its own: for stride
    1, SAME padding and 3x3 taps it is exactly the forward of g with the
    weights turned 180 degrees, ``depthwise_conv3x3(g, w.flip(-1, -2))``."""
    B, H, W, C = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(dt), (0, 0, 1, 1, 1, 1))
    gf = g.to(dt)
    taps = [(xp[:, di:di + H, dj:dj + W, :] * gf).sum(dim=(0, 1, 2))
            for di in range(3) for dj in range(3)]
    return torch.stack(taps, dim=-1).reshape(C, 1, 3, 3)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric INT8 of an (M,N) f32 tensor: (codes int8, scales
    (M,) f32). ``torch.round`` rounds half to even, as ``jnp.round``."""
    s = torch.clamp_min(x.abs().amax(dim=-1), 1e-8) / _scalar(127.0, x)
    q = torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8)
    return q, s


NEG_INF = -1e30        # the reference kernels' mask value, never -inf


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type: f32, or f64 for f64 inputs (an
    f64 evaluation is the yardstick of the f32 ones)."""
    return torch.promote_types(t.dtype, torch.float32)


def _capped(q: torch.Tensor, k: torch.Tensor, softcap: float = 0.0
            ) -> torch.Tensor:
    """Scaled scores of q (B,H,S,D) against k (B,K,S,D) in ``_acc``, kv head
    h // (H/K) for query head h, with the logit softcap ``softcap *
    tanh(score / softcap)`` if ``softcap`` > 0 (the reference's
    ``_softcap``); no mask."""
    D = q.shape[-1]
    dt = _acc(q)
    kf = k.to(dt).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    scores = torch.matmul(q.to(dt), kf.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    return scores


def visible(S: int, causal: bool, window: int = 0, device=None
            ) -> torch.Tensor:
    """(S, S) bool, query row i sees key j: j <= i if causal, and with a
    sliding window also j > i - window (the reference's local-layer mask,
    ``src/repro/models/layers.py:184-191``); all True otherwise."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _masked(scores: torch.Tensor, causal: bool, window: int
            ) -> torch.Tensor:
    """(..., S, S) scores set to NEG_INF where ``visible`` is False."""
    if not (causal or window > 0):
        return scores
    S = scores.shape[-1]
    return scores.masked_fill(~visible(S, causal, window, scores.device),
                              NEG_INF)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int = 0,
            softcap: float = 0.0) -> torch.Tensor:
    """``_capped`` scores, masked with NEG_INF where ``visible`` is False."""
    return _masked(_capped(q, k, softcap), causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (B,H,S,D) over k, v (B,K,S,D), K dividing H (query
    head h reads kv head h // (H/K)); any strides, any D. Scores, softmax and
    the probability-weighted sum of v all in fp32 (f64 for f64 inputs), in
    the reference's order: scale 1/sqrt(D), the softcap ``softcap *
    tanh(s / softcap)`` if ``softcap`` > 0, then the causal mask and, if
    ``window`` > 0, the sliding window (``visible``) with ``NEG_INF``, then
    the softmax; output (B,H,S,D) in q's dtype, as the kernel computes it
    (the kernel's online softmax reaches the same sums in another order)."""
    G = q.shape[1] // k.shape[1]
    probs = torch.softmax(_scores(q, k, causal, window, softcap), dim=-1)
    vf = v.to(probs.dtype).repeat_interleave(G, dim=1)
    return torch.matmul(probs, vf).to(q.dtype)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled (capped, masked) scores,
    (B,H,S), what the kernel's forward writes for the backward (f32; f64 for
    f64 inputs)."""
    return torch.logsumexp(_scores(q, k, causal, window, softcap), dim=-1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of ``flash_attention`` for the output
    gradient ``do``, step by step as the kernels compute them (not
    autograd), in fp32 (f64 for f64 inputs), returned in q's dtype:

        Sc = cap tanh(scale q k^T / cap)   (scale q k^T without a cap)
        P = exp(Sc - lse)      (0 where the key is not visible)
        dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO o O)
        dS = P o (dP - delta) o f,  dQ = scale dS K,  dK = scale dS^T Q

    f = 1 - (Sc / cap)^2 = 1 - tanh^2, the softcap's derivative (1 without
    one). dK and dV summed over the query heads of each kv head's group."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    dt = _acc(q)
    scale = 1.0 / math.sqrt(D)
    sc = _capped(q, k, softcap)
    p = torch.exp(_masked(sc, causal, window) - lse.to(dt)[..., None])
    dof = do.to(dt)
    kf = k.to(dt).repeat_interleave(G, dim=1)
    vf = v.to(dt).repeat_interleave(G, dim=1)
    delta = (dof * o.to(dt)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    if softcap > 0:
        ds = ds * (1 - (sc / softcap) ** 2)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(dt)) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = dk.reshape(B, K, G, S, D).sum(2)
    dv = dv.reshape(B, K, G, S, D).sum(2)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# The kernels' tanh against torch's: tanhf is within 2 ulps of tanh, and the
# kernels form its argument as score * (scale / cap) where the reference
# divides (one rounding more); 4 ulps of a value at most 1 cover both, so
# a capped score is off by at most cap * TANH_ERR and each probability, taken
# relative to its row's sum, by at most 2 cap TANH_ERR relative
TANH_ERR = 2.0 ** -21


def flash_bwd_limit(want: Tuple[torch.Tensor, ...], q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, causal: bool,
                    tol: float, bf16: bool, window: int = 0,
                    softcap: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Element-by-element bounds on |got - want| for the kernel backward's
    (dq, dk, dv) against ``want``, ``flash_attention_bwd`` in f32 on the
    same (upcast) inputs:

        tol (1 + M) [+ 2^-8 (|want| + M) for bf16]
                    [+ (2 cap + 2) TANH_ERR M with a softcap]

    M is each gradient's magnitude, the same sums taken over the absolute
    values of their terms (P, |dO| |V|^T + rowsum|dO o O|, |Q|, |K|; the
    softcap's factor f <= 1 left out): the f32 sums of the kernels and of
    the plain version round in other orders, and a sum's rounding error is
    bounded by its terms' magnitude, not by its value (dS cancels in dP -
    delta). The bf16 kernels read their inputs exactly and compute S, dP,
    delta and every sum in f32, but round P and dS to bf16 (each at most
    2^-9 relative) as the operands of the dV, dK and dQ products, which
    moves each sum by at most 2^-9 M, and round each output (2^-9 |want|);
    2^-8 covers both with a factor two to spare. With a softcap the
    kernels' tanh moves each P by at most 2 cap TANH_ERR relative and f by
    at most 2 TANH_ERR absolute."""
    B, H, S, D = q.shape
    K = k.shape[1]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    p = torch.exp(_scores(q.float(), k.float(), causal, window, softcap)
                  - lse.float()[..., None])
    da = do.float().abs()
    ka = k.float().abs().repeat_interleave(G, dim=1)
    va = v.float().abs().repeat_interleave(G, dim=1)
    dsm = p * (torch.matmul(da, va.transpose(-1, -2))
               + (da * o.float().abs()).sum(-1, keepdim=True))
    mags = (torch.matmul(dsm, ka) * scale,
            (torch.matmul(dsm.transpose(-1, -2), q.float().abs()) * scale)
            .reshape(B, K, G, S, D).sum(2),
            torch.matmul(p.transpose(-1, -2), da).reshape(B, K, G, S, D)
            .sum(2))
    tanh = (2 * softcap + 2) * TANH_ERR if softcap > 0 else 0.0
    return tuple(tol * (1 + m) + tanh * m
                 + (BF16_ULP * (w.float().abs() + m) if bf16 else 0)
                 for m, w in zip(mags, want))


BF16_ULP = 2.0 ** -8    # a bf16 ulp relative to the value (8 mantissa bits)


def flash_bf16_limit(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, causal: bool, tol: float,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Element-by-element bound on |got - want| for a bf16 attention
    ``got`` against ``want``, the plain f32 ``flash_attention`` of the same
    (upcast) q, k, v:

        tol (1 + |want|) + 2^-8 |want| + 2^-8 A(q, k, |v|)
                         [+ 2 cap TANH_ERR A(q, k, |v|) with a softcap]

    ``tol`` covers the other order of the fp32 sums; 2^-8 |want| and
    2^-8 A(q, k, |v|), A the plain f32 attention applied to |v|, cover
    the three roundings to bf16 (each at most 2^-9 relative): the
    probabilities before the PV product, as the model's reference rounds
    them, the denominator they are taken against, and the output; the
    last term the kernel's tanh (``flash_limit``)."""
    a = flash_attention(q.float(), k.float(), v.float().abs(), causal,
                        window, softcap)
    return tol * (1 + want.abs()) + BF16_ULP * (want.abs() + a) + (
        2 * softcap * TANH_ERR * a if softcap > 0 else 0)


def flash_limit(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, causal: bool, tol: float, window: int = 0,
                softcap: float = 0.0) -> torch.Tensor:
    """Element-by-element bound on |got - want| for an f32 attention
    ``got`` against the plain ``want`` on the same inputs:

        tol (1 + |want|) [+ 2 cap TANH_ERR A(q, k, |v|) with a softcap]

    ``tol`` for the other order of the sums; with a softcap, each capped
    score of the kernel is off by at most cap TANH_ERR, which moves each
    probability (relative to its row) by at most 2 cap TANH_ERR and so the
    output by at most that times A, the attention applied to |v|."""
    lim = tol * (1 + want.abs())
    if softcap > 0:
        lim = lim + 2 * softcap * TANH_ERR * flash_attention(
            q.float(), k.float(), v.float().abs(), causal, window, softcap)
    return lim


def ssd_chunk_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Mamba-2 inter-chunk state recurrence over states (B,NC,H,P,N) and
    decay (B,NC,H): ``s_0 = 0, s_{c+1} = s_c * decay_c + states_c``, returning
    s_c for each c (the state before chunk c), fp32 carry (f64 for f64
    states), in the states' dtype."""
    dt = _acc(states)
    s = torch.zeros_like(states[:, 0], dtype=dt)
    out = torch.empty_like(states)
    for c in range(states.shape[1]):
        out[:, c] = s.to(states.dtype)
        s = s * decay[:, c, :, None, None].to(dt) + states[:, c].to(dt)
    return out


def ssd_chunk_scan_bwd(g: torch.Tensor, out: torch.Tensor,
                       decay: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dstates in g's dtype, ddecay (B,NC,H) in f32, f64 for
    f64 inputs) of ``ssd_chunk_scan`` for the output gradient g, from its
    output ``out``: the reverse scan, written out as the kernel runs it,

        lam_{NC-1} = g_{NC-1},  lam_c = g_c + lam_{c+1} decay_c,
        dstates_c = lam_{c+1},  ddecay_c = sum_{p,n} lam_{c+1} s_c,

    with lam_{NC} = 0; each product and sum rounded on its own (the kernel
    is bit-equal in dstates; ddecay's sums run in another order)."""
    dt = _acc(g)
    lam = torch.zeros_like(g[:, 0], dtype=dt)
    dstates = torch.empty_like(g, memory_format=torch.contiguous_format)
    ddecay = torch.empty(decay.shape, dtype=dt, device=g.device)
    for c in reversed(range(g.shape[1])):
        dstates[:, c] = lam.to(g.dtype)
        ddecay[:, c] = (lam * out[:, c].to(dt)).sum(dim=(-2, -1))
        lam = g[:, c].to(dt) + lam * decay[:, c, :, None, None].to(dt)
    return dstates, ddecay
