"""Building blocks of the LM stack, port of ``repro.models.layers``.

Functional like the reference: ``f(cfg, p, x, ...) -> y`` on tensors, with
the reference's parameter layout (dense weights ``(in, out)``, used as
``x @ w``). Activations are in the model dtype (bf16); norms, softmax and
the SSD accumulation run in fp32, rounding where the reference rounds.

The prefill attention is one ``kernels.ops.flash_attention`` call over
the whole sequence, causal (the reference's block-triangular ``q_block``
loop is what that kernel computes, its sliding window and logit softcap
included) or not (the encoder's); the SSD prefill's inter-chunk state pass
is ``kernels.ops.ssd_chunk_scan`` (the reference computes it with a segsum
einsum). Decode runs neither kernel, as in the reference. Cross-attention
is the plain ``_sdpa_block``, as the reference computes it outside any
Pallas kernel: the flash kernels take equal query and key lengths, as the
TPU kernel does. The MoE layer's products are torch products, as the
reference leaves them to XLA.

Under a bound mesh (``sharding.use_mesh``) the parameters and activations
are DTensors: ``shard`` annotations sit where the reference's do, and both
kernels run per shard under ``local_map`` (attention over batch and heads,
the scan over batch and heads), forward and backward. The MoE routes on
its tokens made whole on every rank, so its capacity and slots are the
unsharded ones, then dispatches into capacity-sharded buffers. Outside a
mesh nothing of this runs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, _scalar
from repro_torch.models.params import ParamDef
from repro_torch.sharding import shard

f32 = torch.float32


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """Where the reference computes in fp32: fp32 for bf16 and f32
    activations, f64 for f64 ones (an f64 evaluation of the model is the
    yardstick of its f32 gradients)."""
    return torch.promote_types(t.dtype, f32)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(acc_dtype(x))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(xf.dtype))).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in fp32 (population variance), weight
    and bias, back in x's dtype. No config of the repo uses it (whisper's
    norms are ``rmsnorm``, as in the reference)."""
    xf = x.to(acc_dtype(x))
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.to(xf.dtype)
            + b.to(xf.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None,
                     dtype: torch.dtype = f32) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=dtype, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Half-split rotation with
    fp32 angles (f64 for f64 x), output in x's dtype."""
    ad = acc_dtype(x)
    freqs = rope_frequencies(x.shape[-1], theta, x.device, ad)  # (hd/2,)
    ang = positions.to(ad)[..., None] * freqs                    # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(ad), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_angles(position: torch.Tensor, dim: int,
                      dtype: torch.dtype = f32) -> torch.Tensor:
    """(..., dim) absolute positional rows [sin | cos] of the angles
    position * exp(-ln(10000) 2i / dim), i < dim / 2, computed in
    ``dtype`` (fp32, or f64 for an f64 evaluation) as the reference does,
    for positions of any shape."""
    div = torch.exp(-math.log(10_000.0)
                    * torch.arange(0, dim, 2, dtype=dtype,
                                   device=position.device) / dim)
    ang = position.to(dtype)[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(length: int, dim: int, device=None,
                         dtype: torch.dtype = f32) -> torch.Tensor:
    """(length, dim) rows of ``sinusoidal_angles`` at positions 0..length-1
    (the reference's ``sinusoidal_embedding``, fp32)."""
    return sinusoidal_angles(torch.arange(length, dtype=dtype,
                                          device=device), dim, dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_param_defs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> Dict:
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    ax = tuple(["layer"] * len(layer_dim))
    d = {
        "norm": ParamDef(layer_dim + (D,), ax + ("embed",), "zeros"),
        "wq": ParamDef(layer_dim + (D, Q), ax + ("fsdp", "tensor"), "scaled"),
        "wk": ParamDef(layer_dim + (D, KV), ax + ("fsdp", "tensor"), "scaled"),
        "wv": ParamDef(layer_dim + (D, KV), ax + ("fsdp", "tensor"), "scaled"),
        "wo": ParamDef(layer_dim + (Q, D), ax + ("tensor", "fsdp"), "scaled"),
    }
    if cfg.qk_norm:
        d["q_norm"] = ParamDef(layer_dim + (cfg.head_dim,), ax + (None,),
                               "zeros")
        d["k_norm"] = ParamDef(layer_dim + (cfg.head_dim,), ax + (None,),
                               "zeros")
    return d


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """``cap * tanh(scores / cap)``, or the scores as they are for cap 0."""
    if cap <= 0:
        return scores
    return cap * torch.tanh(scores / cap)


def window_of(cfg: ModelConfig, is_local: bool) -> int:
    """The sliding window of a sublayer: the config's on local layers, 0
    (none) elsewhere."""
    return cfg.sliding_window if (is_local and cfg.sliding_window) else 0


def _group_q(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B,T,H,hd) -> (B,T,K,G,hd): group query heads by their kv head.
    Under a mesh whose head split does not divide the K groups, the heads
    are made whole first (as in ``_split_heads``)."""
    B, T, H, hd = q.shape
    if sharding.current_mesh() is not None and not sharding.heads_split(
            num_kv, "kv_heads"):
        q = sharding.whole_dim(q, 2)
    return q.reshape(B, T, num_kv, H // num_kv, hd)


def _split_heads(t: torch.Tensor, n: int, hd: int, axis: str
                 ) -> torch.Tensor:
    """(..., n*hd) -> (..., n, hd). Under a mesh, a projection split over
    ranks that do not divide its n heads (8 kv heads on a 16-way axis) is
    made whole on that dim first: DTensor cannot split a dim across a head
    boundary, where the reference's GSPMD reshards."""
    if sharding.current_mesh() is not None and not sharding.heads_split(
            n, axis):
        t = sharding.whole_dim(t, -1)
    return t.reshape(*t.shape[:-1], n, hd)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, heads..., hd) -> (B, S, heads * hd). Under a mesh per shard
    (batch and the first head dim keep their split), so that the
    gradient's way back, an unflatten, never meets a split that cuts a
    head (DTensor refuses it)."""
    B, S = t.shape[:2]
    if sharding.current_mesh() is None:
        return t.reshape(B, S, -1)
    from torch.distributed.tensor import Replicate
    pl = tuple(p if not p.is_shard() or p.dim in (0, 2) else Replicate()
               for p in t.placements)
    return _per_shard(lambda a: a.reshape(a.shape[0], a.shape[1], -1),
                      (pl,), (pl,), t)


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
         positions: torch.Tensor):
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd, "heads")
    k = _split_heads(x @ p["wk"], K, hd, "kv_heads")
    v = _split_heads(x @ p["wv"], K, hd, "kv_heads")
    if cfg.qk_norm:                   # per head, before RoPE
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:            # 0: sinusoidal positions (_embed)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def _sdpa_block(q, k, v, mask, softcap: float, scale: float,
                bf16_chain: bool = False):
    """Decode and cross-attention tile, grouped-query form, as the
    reference's ``_sdpa_block``: fp32 QK scores (f64 for f64 q), the
    softcap, the mask, softmax, probabilities rounded to q's dtype before
    the PV product.

    q: (B,T,K,G,hd); k/v: (B,L,K,hd); mask broadcastable to (B,K,G,T,L).

    Under a mesh the tile runs per shard of batch and kv heads, the keys
    and the query's positions whole (``_per_shard``): DTensor's view rules
    in torch 2.11 refuse its flatten of a split kv-head dim (F4). Keys
    split along their sequence (the decode cells' sequence-parallel
    caches: ``kv_seq`` on "model" where the kv heads do not divide it, on
    the data axes for long_500k) stay DTensors, whose softmax gathers the
    scores rather than the cache."""
    if sharding.current_mesh() is None or (sharding.is_dtensor(k) and any(
            p.is_shard(1) for p in k.placements)):
        return _sdpa_tile(q, k, v, mask, softcap, scale, bf16_chain)
    q = shard(q, "batch", None, "kv_heads", None, None)
    k = shard(k, "batch", None, "kv_heads", None)
    v = shard(v, "batch", None, "kv_heads", None)
    if mask is not None:
        mask = shard(mask, "batch", None, None, None, None)
    pl = [None if t is None else tuple(t.placements) for t in (q, k, v, mask)]
    return _per_shard(_sdpa_tile, (*pl, None, None, None), (pl[0],),
                      q, k, v, mask, softcap, scale, bf16_chain)


def _sdpa_tile(q, k, v, mask, softcap: float, scale: float,
               bf16_chain: bool):
    """``_sdpa_block`` on plain tensors, a rank's shards, or DTensors
    whose keys are split along their sequence."""
    B, T, K, G, hd = q.shape
    L = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B, K, G * T, hd)
    kf = k.permute(0, 2, 1, 3)                                   # (B,K,L,hd)
    ad = acc_dtype(q)
    scores = torch.matmul(qf.to(ad), kf.to(ad).transpose(-1, -2)) * scale
    scores = shard(scores.reshape(B, K, G, T, L), "batch", "kv_heads", None,
                   None, None)
    scores = _softcap(scores, softcap)
    if bf16_chain:
        # subtract the fp32 row max first, then drop to bf16
        m = (torch.amax(scores.masked_fill(~mask, -math.inf), dim=-1,
                        keepdim=True)
             if mask is not None else torch.amax(scores, -1, keepdim=True))
        scores = (scores - m).to(torch.bfloat16)
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        e = torch.exp(scores)
        probs = e / torch.sum(e, dim=-1, keepdim=True)
    else:
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
    pf = probs.to(q.dtype).reshape(B, K, G * T, L)
    vf = v.permute(0, 2, 1, 3)                                   # (B,K,L,hd)
    out = torch.matmul(pf, vf.to(q.dtype))
    return out.reshape(B, K, G, T, hd).permute(0, 3, 1, 2, 4)


def attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              positions: torch.Tensor, *, is_local: bool = False,
              causal: bool = True) -> torch.Tensor:
    """Train / prefill attention: one flash-attention call over the whole
    sequence, reading the seq-major projections through strides, causal
    or (the encoder's) not; local layers pass the config's sliding window,
    every layer its logit softcap (the reference's mask and ``_softcap``,
    ``layers.py:174-191``)."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = _flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal, window_of(cfg, is_local),
                 cfg.attn_logit_softcap)                         # (B,H,S,hd)
    out = _merge_heads(out.transpose(1, 2))                    # (B,S,H*hd)
    return shard(out @ p["wo"], "batch", "seq", "embed")


def _per_shard(fn, in_pl, out_pl, *args, in_grad=None):
    """``fn`` on each rank's local shards of ``args`` (redistributed to
    ``in_pl``, one entry per argument, None for a non-tensor), its outputs
    taken as shards at ``out_pl``: ``local_map``, differentiable, so a
    kernel's backward ``Function`` runs per shard too. ``in_grad``: the
    placements of the arguments' gradients where they differ from
    ``in_pl`` (a weight used by a batch shard has a partial gradient).
    Inside ``fn`` no mesh is bound."""
    from torch.distributed.tensor.experimental import local_map

    def local(*a):
        with sharding.unbound():
            return fn(*a)
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=in_grad,
                     device_mesh=sharding.current_mesh(),
                     redistribute_inputs=True)(*args)


def per_batch_shard(fn, *args, whole=()):
    """``fn(*args)``; under a mesh on each rank's batch shard: every tensor
    argument split on its dim 0 over the batch axes and whole otherwise,
    except the arguments at ``whole``, taken whole (a weight: its gradient
    is partial over the batch-split mesh dims), the output split on dim 0.
    DTensor's own sharded gather, and its embedding backward, differ
    between torch releases; this is the plain op on plain shards."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    b = sharding.fix_spec(sharding.resolve_spec(("batch",)),
                          (args[0 if 0 not in whole else 1].shape[0],), mesh)
    split = sharding.placements(b, mesh)
    rep = sharding.placements((), mesh)
    in_pl = tuple(rep if i in whole else split for i in range(len(args)))
    grad = tuple(tuple(Partial() if p.is_shard() else r
                       for p, r in zip(split, rep)) if i in whole else split
                 for i in range(len(args)))
    return _per_shard(fn, in_pl, (split,), *args, in_grad=grad)


def _flash(q, k, v, causal: bool, window: int, softcap: float):
    """``ops.flash_attention``; under a mesh per shard of batch and heads.
    q and k/v share one head placement (a kv head and its query group on
    one rank): where the divisibility rule drops the head axis of either
    (Yi's 56 heads, an 8-kv-head config on a 16-way axis), both take their
    heads whole."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return ops.flash_attention(q, k, v, causal, window, softcap)
    sq = sharding.fix_spec(sharding.resolve_spec(("batch", "heads", None,
                                                  None)), q.shape, mesh)
    sk = sharding.fix_spec(sharding.resolve_spec(("batch", "kv_heads", None,
                                                  None)), k.shape, mesh)
    if sq[1] != sk[1]:
        sq = (sq[0], None, None, None)
    pl = sharding.placements(sq, mesh)
    return _per_shard(ops.flash_attention, (pl, pl, pl, None, None, None),
                      (pl,), q, k, v, causal, window, softcap)


def _write_rows(cache: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor,
                offset=None) -> torch.Tensor:
    """cache[b, slot[b]] = rows[b] for every row b, in place. With an
    ``offset`` the cache is a rank's share of a sequence-split cache that
    starts there: a row is written only where its position lies in the
    share (elsewhere the cache keeps its value)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    if offset is None:
        cache[bidx, slot] = rows
        return cache
    s = slot - offset
    inside = (s >= 0) & (s < cache.shape[1])
    s = torch.clamp(s, 0, cache.shape[1] - 1)
    keep = inside.reshape((-1,) + (1,) * (rows.dim() - 1))
    cache[bidx, s] = torch.where(keep, rows, cache[bidx, s])
    return cache


def _put(cache: torch.Tensor, rows: torch.Tensor, slot: torch.Tensor
         ) -> None:
    """Write each batch row's new position ``rows`` (B, *rest) into the
    decode cache (B, S, *rest) at ``slot`` (B,), in place. Under a mesh the
    cache is split over batch, sequence and heads: each rank writes the
    rows and positions of its own shard (DTensor cannot index_put_ into a
    split sequence in place)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        _write_rows(cache, rows, slot)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = tuple(cache.placements)
    row_pl = tuple(Replicate() if not p.is_shard() or p.dim == 1
                   else Shard(p.dim - 1 if p.dim > 1 else 0) for p in pl)
    slot_pl = tuple(p if p.is_shard(0) else Replicate() for p in pl)
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    _per_shard(_write_rows, (pl, row_pl, slot_pl, None), (pl,), cache,
               rows, slot, int(off[1]))


def attention_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     position: torch.Tensor, *, is_local: bool = False,
                     ring: bool = False, scales=None):
    """Single-token decode. x: (B,1,D); cache: (B,S_len,K,hd); position:
    (B,). The cache (and the INT8 cache's scales) are updated in place;
    returns (out, cache_k, cache_v, scales).

    ``ring=True``: the cache is a ring buffer (slot = position % S_len,
    S_len at most the window), K/V stored RoPE'd at their absolute
    position, so wrapping needs no re-rotation; the window is implied by
    S_len. Without a ring, local layers mask keys at or before position -
    window (the reference's ``layers.py:252-253``)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    S_len = cache_k.shape[1]
    position = position.to(torch.long)
    q, k, v = _qkv(cfg, p, x, position[:, None])
    slot = (position % S_len) if ring else position
    if scales is not None:                    # INT8 cache: quantize new row
        ks, vs = scales
        eps, qmax = 1e-8, _scalar(127.0, x)
        k_sc = torch.amax(k[:, 0].abs().to(f32), dim=-1) / qmax + eps
        v_sc = torch.amax(v[:, 0].abs().to(f32), dim=-1) / qmax + eps
        k_row = torch.clamp(torch.round(k[:, 0].to(f32) / k_sc[..., None]),
                            -127, 127)
        v_row = torch.clamp(torch.round(v[:, 0].to(f32) / v_sc[..., None]),
                            -127, 127)
        _put(cache_k, k_row.to(torch.int8), slot)
        _put(cache_v, v_row.to(torch.int8), slot)
        _put(ks, k_sc.to(ks.dtype), slot)
        _put(vs, v_sc.to(vs.dtype), slot)
    else:
        _put(cache_k, k[:, 0].to(cache_k.dtype), slot)     # in place
        _put(cache_v, v[:, 0].to(cache_v.dtype), slot)
    cache_k = shard(cache_k, "batch", "kv_seq", "kv_heads", None)
    cache_v = shard(cache_v, "batch", "kv_seq", "kv_heads", None)

    kpos = torch.arange(S_len, device=x.device)[None, :]        # (1,S_len)
    if ring:
        # absolute position stored in slot s: the largest p' <= position
        # with p' % S_len == s; valid iff it has been written (p' >= 0)
        stored = position[:, None] - torch.remainder(position[:, None] - kpos,
                                                     S_len)
        mask = stored >= 0
    else:
        mask = kpos <= position[:, None]
        window = window_of(cfg, is_local)
        if window:
            mask &= kpos > position[:, None] - window
    if scales is not None:
        # dequantized views feed the dots; the persistent cache stays int8
        bf = torch.bfloat16
        kf = cache_k.to(bf) * scales[0][..., None].to(bf)
        vf = cache_v.to(bf) * scales[1][..., None].to(bf)
    else:
        kf, vf = cache_k, cache_v
    out = _sdpa_block(_group_q(q, K), kf, vf, mask[:, None, None, None, :],
                      cfg.attn_logit_softcap, 1.0 / math.sqrt(hd),
                      bf16_chain=cfg.decode_bf16_scores)
    out = _merge_heads(out) @ p["wo"]
    return shard(out, "batch", None, "embed"), cache_k, cache_v, scales


def cross_attention(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder-to-encoder attention of x (B,S,D) over precomputed encoder
    K/V (B,F,K,hd): q from ``wq`` (no RoPE, no qk-norm), no mask, no
    softcap, then ``wo`` (the reference's ``layers.py:270-282``). The plain
    ``_sdpa_block``, in prefill and decode alike."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], H, hd, "heads")
    out = _sdpa_block(_group_q(q, K), enc_k, enc_v, None, 0.0,
                      1.0 / math.sqrt(hd))
    return _merge_heads(out) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def mlp_param_defs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    ax = tuple(["layer"] * len(layer_dim))
    d = {
        "norm": ParamDef(layer_dim + (D,), ax + ("embed",), "zeros"),
        "wi_gate": ParamDef(layer_dim + (D, Fd), ax + ("fsdp", "tensor"),
                            "scaled"),
        "wo": ParamDef(layer_dim + (Fd, D), ax + ("tensor", "fsdp"), "scaled"),
    }
    if cfg.mlp_gated:
        d["wi_up"] = ParamDef(layer_dim + (D, Fd), ax + ("fsdp", "tensor"),
                              "scaled")
    return d


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """SiLU, or GeLU in its tanh form: ``jax.nn.gelu``, which the reference
    calls, defaults to ``approximate=True`` (``torch``'s to the erf
    form)."""
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (SwiGLU, or GeGLU for ``act="gelu"``) or, with
    ``mlp_gated`` False, the plain act(x wi_gate) wo (whisper's)."""
    h = _act(x @ p["wi_gate"], cfg.act)
    if cfg.mlp_gated:
        h = h * (x @ p["wi_up"])
    h = shard(h, "batch", "seq", "tensor")
    return shard(h @ p["wo"], "batch", "seq", "embed")


def moe_param_defs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> Dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    ax = tuple(["layer"] * len(layer_dim))
    return {
        "norm": ParamDef(layer_dim + (D,), ax + ("embed",), "zeros"),
        "router": ParamDef(layer_dim + (D, E), ax + ("fsdp", None), "scaled"),
        "we_gate": ParamDef(layer_dim + (E, D, Fd),
                            ax + ("expert", "fsdp", "tensor"), "scaled"),
        "we_up": ParamDef(layer_dim + (E, D, Fd),
                          ax + ("expert", "fsdp", "tensor"), "scaled"),
        "we_down": ParamDef(layer_dim + (E, Fd, D),
                            ax + ("expert", "tensor", "fsdp"), "scaled"),
    }


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens: ``ceil(T topk cf / E)``. It depends
    on the batch, as in the reference: a decode step of B tokens has
    C = ceil(2.5 B / 8) at Mixtral's 8 experts, top-2, cf 1.25, so which
    tokens drop depends on who shares the batch."""
    return max(1, int(math.ceil(T * cfg.experts_per_token
                                * cfg.capacity_factor / cfg.num_experts)))


def moe_route(cfg: ModelConfig, logits: torch.Tensor):
    """The reference's routing of T tokens, index for index, from their
    router logits (T, E) in fp32: (probs (T,E), gates (T,topk), expert
    indices (T,topk), slots (T*topk,), capacity C).

    ``lax.top_k`` orders equal probabilities by the lower expert index;
    ``torch.topk`` promises no order, so the experts come from a stable
    descending sort. Bf16 router products make exact ties among the
    experts happen. The assignments are flattened token-major (token t's
    k-th choice at t*topk + k) and each takes the next free slot of its
    expert (an exclusive cumulative count): the order in which a token
    lists its experts decides which tokens find their expert full, and an
    assignment whose slot is C or more is dropped."""
    E, topk = cfg.num_experts, cfg.experts_per_token
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = sorted_p[:, :topk], order[:, :topk]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    # (E, T*topk): the count runs along the contiguous dim (an outer-dim
    # scan of a (T*topk, E) tensor was 3 ms a layer at T = 8192)
    onehot = F.one_hot(eidx.reshape(-1), E).t().contiguous()
    pos = torch.sum((torch.cumsum(onehot, dim=1) - onehot) * onehot, dim=0)
    return probs, gates, eidx, pos, moe_capacity(cfg, T)


def _moe_plan(cfg: ModelConfig, logits: torch.Tensor, dtype: torch.dtype):
    """The routing of T tokens and its dispatch bookkeeping: (probs (T,E),
    the load fractions f_e (E,), the assignments' experts (T*topk,) and
    slots (T*topk,), the (E, C) buffers of token indices (T where empty)
    and gates). Under a mesh it runs whole on every rank."""
    E, topk = cfg.num_experts, cfg.experts_per_token
    T = logits.shape[0]
    probs, gates, eidx, pos, C = moe_route(cfg, logits)
    f_e = torch.mean(torch.sum(F.one_hot(eidx, E).to(logits.dtype), dim=1),
                     dim=0)
    flat_e = eidx.reshape(-1)
    flat_g = gates.reshape(-1).to(dtype)
    flat_t = torch.arange(T * topk, device=logits.device) // topk
    # a dropped assignment writes into a spare column C, cut off after
    # (no data-dependent shapes, so meta tensors trace it too)
    slot = (flat_e, torch.clamp(pos, max=C))
    tok_buf = torch.full((E, C + 1), T, dtype=torch.long,
                         device=logits.device).index_put(slot, flat_t)
    gate_buf = torch.zeros((E, C + 1), dtype=dtype,
                           device=logits.device).index_put(slot, flat_g)
    return probs, f_e, flat_e, pos, tok_buf[:, :C], gate_buf[:, :C]


def _gather_slots(xf: torch.Tensor, tok_buf: torch.Tensor) -> torch.Tensor:
    """(E, C, D) rows of xf (T, D) at the token indices of ``tok_buf``, a
    zero row where a slot is empty."""
    xpad = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))], dim=0)
    return xpad[tok_buf]


def _combine(ye: torch.Tensor, flat_e: torch.Tensor, pos: torch.Tensor,
             C: int) -> torch.Tensor:
    """Each assignment's expert output (T*topk, D), token-major; zero where
    the assignment was dropped."""
    contrib = ye[flat_e, torch.clamp(pos, max=C - 1)]
    return torch.where((pos < C)[:, None], contrib, contrib.new_zeros(()))


def _whole(fn, n_out: int, *args):
    """``fn`` as it is outside a mesh; under one, on every rank over whole
    copies of its tensor arguments, its ``n_out`` outputs replicated (every
    rank computes the same, so the gradients are replicated too)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return fn(*args)
    rep = sharding.placements((), mesh)
    return _per_shard(fn, tuple(rep if torch.is_tensor(a) else None
                                for a in args), (rep,) * n_out, *args)


def _gather_sharded(xf: torch.Tensor, tok_buf: torch.Tensor) -> torch.Tensor:
    """``_gather_slots``; under a mesh from the whole token rows into the
    slots of each rank's shard of ``tok_buf``. A rank's gradient of xf
    holds its slots' rows only, so it is partial over the mesh dims that
    split the buffer."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _gather_slots(xf, tok_buf)
    from torch.distributed.tensor import Partial, Replicate
    pl = tuple(tok_buf.placements)
    grad = tuple(Replicate() if p.is_replicate() else Partial() for p in pl)
    return _per_shard(_gather_slots, (sharding.placements((), mesh), pl),
                      (pl,), xf, tok_buf, in_grad=(grad, pl))


def moe(cfg: ModelConfig, p: Dict, x: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k token-choice MoE with capacity-bounded index dispatch, the
    reference's ``moe`` (``layers.py:310-388``): tokens gathered into an
    (E, C) buffer of slots (``moe_route``; dropped assignments add
    nothing), batched expert FFNs, gate-weighted, gathered back token-major.
    Returns (output, Switch load-balance aux loss E * sum_e f_e P_e).

    Under a mesh the router logits are made whole on every rank and routed
    there, so C = ceil(T topk cf / E) and the slots are those of all T
    tokens, as in the reference's GSPMD program (routing per data shard
    would change C and drop other tokens); the buffers are then split on
    their capacity dim where C >= 4096, as the reference's."""
    B, S, D = x.shape
    E, topk = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = moe_capacity(cfg, T)
    xf = x.reshape(T, D)
    ad = acc_dtype(x)
    logits = (xf @ p["router"]).to(ad)                           # (T,E)
    probs, f_e, flat_e, pos, tok_buf, gate_buf = _whole(
        lambda lg: _moe_plan(cfg, lg, x.dtype), 6, logits)
    aux = E * torch.sum(f_e * torch.mean(probs, dim=0))

    # the capacity dim is split only where the buffers are large (train,
    # prefill), as the reference's: for decode-sized C it forces padding
    cap_ax = "expert_cap" if C >= 4096 else None
    tok_buf = shard(tok_buf, "expert", cap_ax)
    gate_buf = shard(gate_buf, "expert", cap_ax)
    xe = shard(_gather_sharded(xf, tok_buf), "expert", cap_ax, "embed")
    h = (_act(torch.einsum("ecd,edf->ecf", xe, p["we_gate"]), cfg.act)
         * torch.einsum("ecd,edf->ecf", xe, p["we_up"]))
    h = shard(h, "expert", cap_ax, "tensor")
    ye = torch.einsum("ecf,efd->ecd", h, p["we_down"])
    ye = shard(ye * gate_buf[..., None], "expert", cap_ax, "embed")
    contrib = _whole(lambda *a: _combine(*a, C), 1, ye, flat_e, pos)
    y = shard(contrib.reshape(T, topk, D), "batch", None, "embed")
    y = torch.sum(y, dim=1).reshape(B, S, D)
    return shard(y, "batch", "seq", "embed"), aux


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def ssm_param_defs(cfg: ModelConfig, layer_dim: Tuple[int, ...] = ()) -> Dict:
    D = cfg.d_model
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    ax = tuple(["layer"] * len(layer_dim))
    return {
        "norm": ParamDef(layer_dim + (D,), ax + ("embed",), "zeros"),
        "in_proj": ParamDef(layer_dim + (D, 2 * di + 2 * ds + nh),
                            ax + ("fsdp", "tensor"), "scaled"),
        "conv_w": ParamDef(layer_dim + (cfg.ssm_conv_width, conv_dim),
                           ax + (None, "tensor"), "scaled", scale=0.5),
        "conv_b": ParamDef(layer_dim + (conv_dim,), ax + ("tensor",), "zeros"),
        "A_log": ParamDef(layer_dim + (nh,), ax + (None,), "arange_neg"),
        "D_skip": ParamDef(layer_dim + (nh,), ax + (None,), "ones"),
        "dt_bias": ParamDef(layer_dim + (nh,), ax + (None,), "zeros"),
        "gate_norm": ParamDef(layer_dim + (di,), ax + ("tensor",), "zeros"),
        "out_proj": ParamDef(layer_dim + (di, D), ax + ("tensor", "fsdp"),
                             "scaled"),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) lower-tri cumulative segment sums."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _ssm_inputs(cfg: ModelConfig, p: Dict, x: torch.Tensor):
    """Shared in_proj for the prefill and decode paths: (z, xBC, dt)."""
    di, ds = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"]
    return torch.split(zxbcdt, [di, di + 2 * ds, cfg.ssm_heads], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C); w: (K, C); then silu."""
    K, C = w.shape
    xt = F.pad(xBC.transpose(1, 2), (K - 1, 0))                  # (B,C,S+K-1)
    out = F.conv1d(xt, w.t()[:, None, :], groups=C).transpose(1, 2)
    return F.silu(out + b)


def _conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_causal_conv``; under a mesh per shard of batch and channels
    (each channel its own group)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _causal_conv(xBC, w, b)
    from torch.distributed.tensor import Partial
    spec = sharding.fix_spec(sharding.resolve_spec(("batch", None, "tensor")),
                             xBC.shape, mesh)
    pl = sharding.placements(spec, mesh)
    wb = (sharding.placements((None, spec[2]), mesh),
          sharding.placements((spec[2],), mesh))
    # a rank's weight gradient sums its batch shard only: partial over the
    # mesh dims that split the batch
    grad = tuple(tuple(Partial() if p.is_shard(0) else q
                       for p, q in zip(pl, g)) for g in wb)
    return _per_shard(_causal_conv, (pl,) + wb, (pl,), xBC, w, b,
                      in_grad=(pl,) + grad)


def ssd(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD block, chunked prefill form [arXiv:2405.21060]."""
    S = x.shape[1]
    di, ds = cfg.d_inner, cfg.ssm_state
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"ssd: sequence {S} is not a multiple of the chunk "
                         f"{Q}")
    z, xBC, dt = _ssm_inputs(cfg, p, x)
    xBC = _conv(xBC, p["conv_w"], p["conv_b"])
    xs, B_, C_ = torch.split(xBC, [di, ds, ds], dim=-1)
    y = _ssd_block(cfg, xs, dt, B_, C_, p["A_log"], p["dt_bias"],
                   p["D_skip"])
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return shard(y @ p["out_proj"], "batch", "seq", "embed")


def _ssd_chunks(cfg: ModelConfig, xs, dt, B_, C_, A_log, dt_bias, D_skip):
    """The SSD's chunked scan from its conv outputs xs (B,S,H*hd), B_, C_
    (B,S,ds) and raw dt (B,S,H) to y (B,S,H*hd) in xs's dtype, for the H
    heads given (all, or a rank's share: the math is independent over
    batch rows and heads)."""
    B, S, nh = dt.shape
    hd, ds = cfg.ssm_head_dim, B_.shape[-1]
    Q = min(cfg.ssm_chunk, S)
    nc = S // Q
    ad = acc_dtype(xs)
    dt = F.softplus(dt.to(ad) + dt_bias.to(ad))                 # (B,S,nh)
    A = -torch.exp(A_log.to(ad))                                # (nh,)

    X = xs.reshape(B, S, nh, hd).to(ad)
    Xd = X * dt[..., None]
    dA = (dt * A).reshape(B, nc, Q, nh).permute(0, 3, 1, 2)      # (B,nh,nc,Q)
    Bc = B_.reshape(B, nc, Q, ds).to(ad)
    Cc = C_.reshape(B, nc, Q, ds).to(ad)
    Xc = Xd.reshape(B, nc, Q, nh, hd)

    A_cum = torch.cumsum(dA, dim=-1)                             # (B,nh,nc,Q)
    L = torch.exp(_segsum(dA))                                   # (B,nh,nc,Q,Q)
    L = shard(L, "batch", "heads", None, None, None)
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, Xc)

    decay_states = torch.exp(A_cum[..., -1:] - A_cum)            # (B,nh,nc,Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, Xc)
    chunk_sum = A_cum[..., -1]                                   # (B,nh,nc)
    # the state before each chunk: s_0 = 0, s_{c+1} = s_c*exp(sum_c)+states_c
    prev_states = _scan(states, torch.exp(chunk_sum).transpose(1, 2))

    out_decay = torch.exp(A_cum)                                 # (B,nh,nc,Q)
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states, out_decay)
    Y = (Y_diag + Y_off).reshape(B, S, nh, hd)
    Y = Y + D_skip.to(ad)[None, None, :, None] * X
    return Y.reshape(B, S, nh * hd).to(xs.dtype)


def _ssd_block(cfg: ModelConfig, xs, dt, B_, C_, A_log, dt_bias, D_skip):
    """``_ssd_chunks``; under a mesh per shard of batch and heads, in one
    ``local_map`` (the reference's annotation of L asks for that split;
    inside, annotations are no-ops and the scan is its kernel on the local
    shard). B_ and C_ serve every head, so their gradients are partial
    over the head-split mesh dims; the per-head parameters' over the
    batch-split ones."""
    mesh = sharding.current_mesh()
    args = (xs, dt, B_, C_, A_log, dt_bias, D_skip)
    if mesh is None:
        return _ssd_chunks(cfg, *args)
    from torch.distributed.tensor import Partial
    b, _, h = sharding.fix_spec(sharding.resolve_spec(
        ("batch", None, "heads")), dt.shape, mesh)
    act = sharding.placements((b, None, h), mesh)
    shared = sharding.placements((b, None, None), mesh)
    head = sharding.placements((h,), mesh)
    in_pl = (act, act, shared, shared, head, head, head)
    shared_g = tuple(Partial() if a.is_shard(2) else s
                     for a, s in zip(act, shared))
    head_g = tuple(Partial() if a.is_shard(0) else s
                   for a, s in zip(act, head))
    grads = (act, act, shared_g, shared_g, head_g, head_g, head_g)
    return _per_shard(lambda *a: _ssd_chunks(cfg, *a), in_pl, (act,), *args,
                      in_grad=grads)


def _scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``ops.ssd_chunk_scan``; under a mesh per shard of batch and heads
    (the scan is independent over both)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return ops.ssd_chunk_scan(states, decay)
    spec = sharding.fix_spec(sharding.resolve_spec(
        ("batch", None, "heads", None, None)), states.shape, mesh)
    pl = sharding.placements(spec, mesh)
    return _per_shard(ops.ssd_chunk_scan, (pl, pl), (pl,), states, decay)


def ssd_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
               conv_state: torch.Tensor, ssm_state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token SSD step. x: (B,1,D); conv_state: (B,K-1,conv_dim);
    ssm_state: (B,nh,hd,ds). Returns (out, new conv state, new ssm state)."""
    B = x.shape[0]
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xBC, dt = _ssm_inputs(cfg, p, x)                          # (B,1,*)
    window = torch.cat([conv_state, xBC], dim=1)                 # (B,K,conv)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32),
                            p["conv_w"].to(f32)) + p["conv_b"].to(f32)
    xBC = F.silu(conv_out)[:, None, :].to(x.dtype)
    new_conv_state = window[:, 1:]

    xs, B_, C_ = torch.split(xBC, [di, ds, ds], dim=-1)
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))     # (B,nh)
    A = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt * A)                                       # (B,nh)
    X = xs[:, 0].reshape(B, nh, hd).to(f32)
    Bv = B_[:, 0].to(f32)                                        # (B,ds)
    Cv = C_[:, 0].to(f32)
    new_ssm = (ssm_state * dA[..., None, None]
               + dt[..., None, None] * X[..., None] * Bv[:, None, None, :])
    Y = torch.einsum("bhpn,bn->bhp", new_ssm, Cv)
    Y = Y + p["D_skip"].to(f32)[None, :, None] * X
    y = Y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return (shard(y @ p["out_proj"], "batch", None, "embed"), new_conv_state,
            new_ssm)
