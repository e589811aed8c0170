"""The LM stack, port of ``repro.models.lm``: prefill forward and decode.

Parameters are the reference's tree: a period block of sublayers whose
weights are stacked over ``num_repeats`` (leading dim R), in the reference's
layout, so ``models.params.lm_from_jax`` carries a JAX tree across as it is.
A Python loop over the repeats takes the place of ``lax.scan``.

Entry points (functions on tensors, as in the reference):
  * ``param_defs(cfg)`` / ``init_params(cfg, generator, device)``
  * ``forward(cfg, params, tokens, image_embeds=, encoder_frames=)`` --
    prefill logits (fp32)
  * ``encode`` / ``encoder_kv`` -- whisper's encoder and its cross K/V
  * ``lm_loss(cfg, params, batch)`` / ``xent_loss`` -- training loss
  * ``init_cache(cfg, batch, s_max, device)`` + ``decode_step(...)`` -- serving

The decode cache is a dict of stacked tensors that ``decode_step`` updates
in place (the reference donates its cache to the jit instead).

Sublayers: attention (rope or none, qk-norm, grouped-query, sliding
windows with the ring-buffer cache, the attention logit softcap, the INT8
KV cache), cross-attention over an encoder's K/V, gated and plain SiLU and
GeLU MLPs, top-k MoE with its aux loss, and Mamba-2 SSD; around them
sandwich norms, embedding scaling, image embeddings over the first
positions, sinusoidal positions and the final logit softcap.

Under a bound mesh (``sharding.use_mesh``) the same functions run on
DTensors, annotated where the reference annotates them (``shard``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, materialize
from repro_torch import sharding
from repro_torch.sharding import shard

f32 = torch.float32


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def block_period(cfg: ModelConfig) -> int:
    """Length of the repeating layer pattern."""
    p = 1
    if cfg.local_global_period:
        p = math.lcm(p, cfg.local_global_period)
    if cfg.attn_period:
        p = math.lcm(p, cfg.attn_period)
    if cfg.num_experts:
        p = math.lcm(p, cfg.moe_period)
    if cfg.num_layers % p != 0:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} not a "
                         f"multiple of layer pattern period {p}")
    return p


def num_repeats(cfg: ModelConfig) -> int:
    return cfg.num_layers // block_period(cfg)


def sublayer_kind(cfg: ModelConfig, j: int) -> Dict[str, bool]:
    """Static description of sublayer ``j`` of the period block."""
    return dict(
        attn=cfg.is_attn_layer(j),
        ssm=(not cfg.is_attn_layer(j)) and cfg.ssm_state > 0,
        moe=cfg.is_moe_layer(j),
        local=cfg.is_local_layer(j),
        mlp=cfg.d_ff > 0 and not cfg.is_moe_layer(j),
    )


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _sublayer_defs(cfg: ModelConfig, j: int, R: int) -> Dict:
    kind = sublayer_kind(cfg, j)
    ld = (R,)
    d: Dict[str, Dict] = {}
    if kind["attn"]:
        d["attn"] = L.attn_param_defs(cfg, ld)
    if kind["ssm"]:
        d["ssm"] = L.ssm_param_defs(cfg, ld)
    if kind["moe"]:
        d["moe"] = L.moe_param_defs(cfg, ld)
    elif kind["mlp"]:
        d["mlp"] = L.mlp_param_defs(cfg, ld)
    if cfg.sandwich_norm:             # post-sublayer norms (gemma2)
        for key in ("attn", "moe", "mlp"):
            if key in d:
                d[key]["post_norm"] = ParamDef(ld + (cfg.d_model,),
                                               ("layer", "embed"), "zeros")
    if cfg.cross_attention:
        d["xattn"] = L.attn_param_defs(cfg, ld)
    return d


def param_defs(cfg: ModelConfig) -> Dict:
    D, V = cfg.d_model, cfg.vocab_size
    R, period = num_repeats(cfg), block_period(cfg)
    defs: Dict = {
        "embed": ParamDef((V, D), ("tensor", "fsdp"), "normal"),
        "final_norm": ParamDef((D,), ("embed",), "zeros"),
        "blocks": {f"blk{j}": _sublayer_defs(cfg, j, R)
                   for j in range(period)},
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((D, V), ("fsdp", "tensor"), "scaled")
    if cfg.encoder_layers:
        E = cfg.encoder_layers
        defs["encoder"] = {
            "layers": {"attn": L.attn_param_defs(cfg, (E,)),
                       "mlp": L.mlp_param_defs(cfg, (E,))},
            "final_norm": ParamDef((D,), ("embed",), "zeros")}
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Random parameters under the reference's init rules, drawn from a CPU
    ``generator`` (the same seed gives the same weights on every device)."""
    return materialize(param_defs(cfg), generator, device)


def _at(tree: Dict, r: int) -> Dict:
    """Repeat ``r`` of a stacked tree (views, so writes reach the stack)."""
    return {k: _at(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _repeats(tree: Dict, R: int) -> list:
    """Every repeat of a stacked tree, ``[_at(tree, r) for r < R]``, from
    one ``unbind`` per leaf: views as ``_at``'s, and a backward that stacks
    the R gradients once (indexing each repeat alone backs a full-size
    zero-padded gradient per repeat, R^2 traffic over the stack). The
    gradients are the same bits."""
    if R == 0:
        return []
    flat = {k: torch.unbind(v, 0) if not isinstance(v, dict) else None
            for k, v in tree.items()}
    subs = {k: _repeats(v, R) for k, v in tree.items() if isinstance(v, dict)}
    return [{k: subs[k][r] if flat[k] is None else flat[k][r]
             for k in tree} for r in range(R)]


# ---------------------------------------------------------------------------
# sublayers (prefill form)
# ---------------------------------------------------------------------------

def _residual(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """x + h, h first normed by the sublayer's ``post_norm`` under sandwich
    norms (gemma2)."""
    if cfg.sandwich_norm:
        h = L.rmsnorm(h, p["post_norm"], cfg.norm_eps)
    return x + h


def _ffn(cfg: ModelConfig, kind: Dict, p: Dict, x: torch.Tensor,
         aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE or MLP half of a sublayer (pre-norm residual); the MoE's aux
    loss is added to ``aux``."""
    if kind["moe"]:
        h, a = L.moe(cfg, p["moe"], L.rmsnorm(x, p["moe"]["norm"],
                                              cfg.norm_eps))
        return _residual(cfg, p["moe"], x, h), aux + a
    if kind["mlp"]:
        h = L.mlp(cfg, p["mlp"], L.rmsnorm(x, p["mlp"]["norm"], cfg.norm_eps))
        return _residual(cfg, p["mlp"], x, h), aux
    return x, aux


def _cross(cfg: ModelConfig, p: Dict, x: torch.Tensor, enc_k: torch.Tensor,
           enc_v: torch.Tensor) -> torch.Tensor:
    """x plus the pre-norm cross-attention over an encoder's K/V."""
    h = L.rmsnorm(x, p["xattn"]["norm"], cfg.norm_eps)
    return x + L.cross_attention(cfg, p["xattn"], h, enc_k, enc_v)


def _apply_sublayer(cfg: ModelConfig, kind: Dict, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, aux: torch.Tensor,
                    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual sublayer (sandwich norms where configured), with
    cross-attention over ``enc_kv`` between its attention and its FFN;
    returns (x, aux) with the MoE aux loss summed in."""
    if kind["attn"]:
        h = L.rmsnorm(x, p["attn"]["norm"], cfg.norm_eps)
        h = L.attention(cfg, p["attn"], h, positions, is_local=kind["local"])
        x = _residual(cfg, p["attn"], x, h)
    elif kind["ssm"]:
        h = L.rmsnorm(x, p["ssm"]["norm"], cfg.norm_eps)
        x = x + L.ssd(cfg, p["ssm"], h)
    if cfg.cross_attention and enc_kv is not None:
        x = _cross(cfg, p, x, *enc_kv)
    return _ffn(cfg, kind, p, x, aux)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx]


def _images_per_shard(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """``x[:b, :n, :d] = img`` on a mesh: each rank writes the image rows
    of its batch shard into a copy of its shard (a rank's image gradient
    covers its rows only: partial over the batch-split mesh dims)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = sharding.current_mesh()
    pl = tuple(x.placements)
    off = int(compute_local_shape_and_global_offset(x.shape, mesh, pl)[1][0])
    b, n, d = img.shape

    def write(xl, whole):
        r1 = max(0, min(xl.shape[0], b - off))
        xl = xl.clone()
        xl[:r1, :n, :d] = whole[off:off + r1]
        return xl
    rep = sharding.placements((), mesh)
    grad = tuple(Partial() if q.is_shard() else r for q, r in zip(pl, rep))
    return L._per_shard(write, (pl, rep), (pl,), x, img, in_grad=(pl, grad))


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
           image_embeds: Optional[torch.Tensor] = None,
           position: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding rows of ``tokens``, times sqrt(d_model) rounded to the
    activation dtype if ``scale_embedding`` (gemma2), as the reference
    multiplies; ``image_embeds`` (B', N, D'), cast to the activation dtype,
    written over the first N positions of the first B' rows (it must fit,
    as ``lax.dynamic_update_slice`` demands); then, with ``rope_theta`` 0,
    sinusoidal positions: the table of S rows rounded to the activation
    dtype in prefill, each row's angles at its ``position`` (B,) in
    decode."""
    x = L.per_batch_shard(_rows, params["embed"], tokens.to(torch.long),
                          whole=(0,))
    if cfg.scale_embedding:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.num_image_tokens and image_embeds is not None:
        if image_embeds.dim() != 3 or any(
                n > m for n, m in zip(image_embeds.shape, x.shape)):
            raise ValueError(f"{cfg.name}: image_embeds "
                             f"{tuple(image_embeds.shape)} do not fit in the "
                             f"embedded tokens {tuple(x.shape)}")
        if sharding.current_mesh() is not None:
            x = _images_per_shard(x, image_embeds.to(x.dtype))
        else:
            b, n, d = image_embeds.shape
            x[:b, :n, :d] = image_embeds.to(x.dtype)
    if cfg.rope_theta == 0:                      # absolute sinusoidal pos
        ad = L.acc_dtype(x)
        if position is not None:                 # decode: (B,) positions
            pos = L.sinusoidal_angles(position, cfg.d_model, ad)[:, None, :]
        else:
            pos = L.sinusoidal_embedding(x.shape[1], cfg.d_model, x.device,
                                         ad)[None]
        x = x + pos.to(x.dtype)
    return shard(x, "batch", "seq", "embed")


def _unembed(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and head; the product is rounded to the activation dtype
    before the cast to fp32, as in the reference; then the final logit
    softcap, if any."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    logits = (x @ head.to(x.dtype)).to(L.acc_dtype(x))
    return shard(L._softcap(logits, cfg.final_logit_softcap), "batch", "seq",
                 "vocab")


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """Bidirectional encoder over precomputed frame embeddings (B,F,D):
    frames plus sinusoidal positions (rounded to their dtype), then
    ``encoder_layers`` pre-norm layers of non-causal attention (the flash
    kernels with ``causal=False``) and MLP, then a final rmsnorm."""
    enc = params["encoder"]
    B, F_, D = frames.shape
    pos = L.sinusoidal_embedding(F_, D, frames.device,
                                 L.acc_dtype(frames))
    x = shard(frames + pos.to(frames.dtype)[None], "batch", "seq", "embed")
    positions = torch.arange(F_, device=x.device)[None].expand(B, F_)
    for p in _repeats(enc["layers"], cfg.encoder_layers):
        h = L.rmsnorm(x, p["attn"]["norm"], cfg.norm_eps)
        x = x + L.attention(cfg, p["attn"], h, positions, causal=False)
        h = L.rmsnorm(x, p["mlp"]["norm"], cfg.norm_eps)
        x = x + L.mlp(cfg, p["mlp"], h)
    return L.rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def encoder_kv(cfg: ModelConfig, params: Dict, enc_out: torch.Tensor
               ) -> Dict[str, list]:
    """The cross-attention K/V of every decoder layer, computed once per
    request: {"k": [...], "v": [...]}, one (R, B, F, K, hd) tensor per
    sublayer of the period block (an einsum over the repeat dim, as the
    reference's ``lm.py:215-234``)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    ks, vs = [], []
    for j in range(block_period(cfg)):
        p = params["blocks"][f"blk{j}"]["xattn"]
        if sharding.current_mesh() is None:
            k = torch.einsum("bfd,rde->rbfe", enc_out, p["wk"])
            v = torch.einsum("bfd,rde->rbfe", enc_out, p["wv"])
        else:       # the einsum's views would cut heads split on a mesh
            k = torch.stack([enc_out @ w for w in p["wk"]])
            v = torch.stack([enc_out @ w for w in p["wv"]])
        ks.append(L._split_heads(k, K, hd, "kv_heads"))
        vs.append(L._split_heads(v, K, hd, "kv_heads"))
    return {"k": ks, "v": vs}


# ---------------------------------------------------------------------------
# prefill forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of tokens (B,S) on the parameters' device,
    with ``image_embeds`` (B, N, D) over the first N positions (VLM
    configs) and, for an encoder-decoder config, its ``encoder_frames``
    (B, F, D), which it needs. Returns (logits fp32 (B,S,V),
    moe_aux_loss): the MoE layers' aux losses summed and divided by
    ``num_layers`` (0 without MoE)."""
    B, S = tokens.shape
    period = block_period(cfg)
    x = _embed(cfg, params, tokens, image_embeds)          # (B,S,D) gather
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    enc_kv = None
    if cfg.encoder_layers:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its forward "
                             "(and a training batch) needs encoder_frames "
                             f"(B, F, {cfg.d_model})")
        enc_kv = encoder_kv(cfg, params, encode(cfg, params, encoder_frames))
    aux = torch.zeros((), dtype=L.acc_dtype(x), device=x.device)
    kinds = [sublayer_kind(cfg, j) for j in range(period)]
    for r, blk in enumerate(_repeats(params["blocks"], num_repeats(cfg))):
        for j in range(period):
            ekv = None if enc_kv is None else (enc_kv["k"][j][r],
                                               enc_kv["v"][j][r])
            x, aux = _apply_sublayer(cfg, kinds[j], blk[f"blk{j}"], x,
                                     positions, aux, ekv)
    return _unembed(cfg, params, x), aux / max(1, cfg.num_layers)


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, s_max: int) -> Dict:
    """ParamDef tree of the decode cache: attention sublayers carry (k, v)
    (INT8 with per-(position, head) scales if ``cfg.kv_cache_int8``), SSM
    sublayers a conv window and the SSD state, and an encoder-decoder's
    every sublayer the cross-attention K/V (xk, xv) of its
    ``num_encoder_frames``. Local layers of a config with
    ``swa_ring_buffer`` keep min(s_max, window) positions, a ring buffer
    (``_decode_sublayer``)."""
    R, period = num_repeats(cfg), block_period(cfg)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    dt = cfg.dtype
    cache: Dict = {}
    for j in range(period):
        kind = sublayer_kind(cfg, j)
        c: Dict = {}
        if kind["attn"]:
            s_len = s_max
            if kind["local"] and cfg.swa_ring_buffer and cfg.sliding_window:
                s_len = min(s_max, cfg.sliding_window)
            axes = ("layer", "batch", "kv_seq", "kv_heads", None)
            cdt = "int8" if cfg.kv_cache_int8 else dt
            c["k"] = ParamDef((R, batch, s_len, K, hd), axes, "zeros", cdt)
            c["v"] = ParamDef((R, batch, s_len, K, hd), axes, "zeros", cdt)
            if cfg.kv_cache_int8:
                sax = ("layer", "batch", "kv_seq", "kv_heads")
                c["k_scale"] = ParamDef((R, batch, s_len, K), sax, "zeros",
                                        dt)
                c["v_scale"] = ParamDef((R, batch, s_len, K), sax, "zeros",
                                        dt)
        if kind["ssm"]:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            c["conv"] = ParamDef((R, batch, cfg.ssm_conv_width - 1, conv_dim),
                                 ("layer", "batch", None, "tensor"), "zeros",
                                 dt)
            c["ssm"] = ParamDef((R, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state),
                                ("layer", "batch", "heads", None, None),
                                "zeros", "float32")
        if cfg.cross_attention:
            F_ = cfg.num_encoder_frames
            axes = ("layer", "batch", None, "kv_heads", None)
            c["xk"] = ParamDef((R, batch, F_, K, hd), axes, "zeros", dt)
            c["xv"] = ParamDef((R, batch, F_, K, hd), axes, "zeros", dt)
        cache[f"blk{j}"] = c
    return cache


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = "cuda") -> Dict:
    """A zeroed decode cache (every leaf of ``cache_defs`` is zeros, so the
    generator draws nothing)."""
    return materialize(cache_defs(cfg, batch, s_max), torch.Generator(),
                       device)


def _decode_sublayer(cfg: ModelConfig, kind: Dict, p: Dict, c: Dict,
                     x: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """One sublayer of one decode step; writes its cache ``c`` in place
    (cross-attention reads its xk/xv and leaves them). A local layer's
    cache no longer than the window is a ring buffer (the reference's
    condition, ``lm.py:333-334``); the MoE's aux loss is dropped, as in the
    reference's decode."""
    if kind["attn"]:
        h = L.rmsnorm(x, p["attn"]["norm"], cfg.norm_eps)
        ring = bool(kind["local"] and cfg.swa_ring_buffer
                    and cfg.sliding_window
                    and c["k"].shape[1] < cfg.sliding_window + 1)
        scales = ((c["k_scale"], c["v_scale"]) if cfg.kv_cache_int8
                  else None)
        h, _, _, _ = L.attention_decode(cfg, p["attn"], h, c["k"], c["v"],
                                        position, is_local=kind["local"],
                                        ring=ring, scales=scales)
        x = _residual(cfg, p["attn"], x, h)
    elif kind["ssm"]:
        h = L.rmsnorm(x, p["ssm"]["norm"], cfg.norm_eps)
        h, nconv, nssm = L.ssd_decode(cfg, p["ssm"], h, c["conv"], c["ssm"])
        c["conv"].copy_(nconv)
        c["ssm"].copy_(nssm)
        x = x + h
    if cfg.cross_attention:
        x = _cross(cfg, p, x, c["xk"], c["xv"])
    return _ffn(cfg, kind, p, x, x.new_zeros((), dtype=f32))[0]


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor, position: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B,1) int; position: (B,) int.

    Returns (logits fp32 (B,V), cache); the cache is updated in place and
    returned for symmetry with the reference. Decode is text-only (no
    image embeddings, as in the reference); sinusoidal positions come from
    ``position``."""
    period = block_period(cfg)
    x = _embed(cfg, params, tokens, None, position=position)
    kinds = [sublayer_kind(cfg, j) for j in range(period)]
    R = num_repeats(cfg)
    for blk, blk_cache in zip(_repeats(params["blocks"], R),
                              _repeats(cache, R)):
        for j in range(period):
            x = _decode_sublayer(cfg, kinds[j], blk[f"blk{j}"],
                                 blk_cache[f"blk{j}"], x, position)
    return _unembed(cfg, params, x)[:, -1, :], cache


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.long)[..., None])[..., 0]
    return logz - gold


def xent_loss(logits: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy; logits fp32 (B,S,V), labels (B,S);
    with ``mask`` the masked mean (over at least one position). Under a
    mesh each rank takes its batch shard's rows with the vocab whole."""
    nll = L.per_batch_shard(_nll, logits, labels)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def lm_loss(cfg: ModelConfig, params: Dict, batch: Dict,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict]:
    """(total loss, {"xent", "moe_aux"}) of a batch {"tokens", "labels"[,
    "mask", "image_embeds", "encoder_frames"]} of tensors on the
    parameters' device: the cross entropy plus ``aux_weight`` times the MoE
    aux loss (0 without MoE)."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          image_embeds=batch.get("image_embeds"),
                          encoder_frames=batch.get("encoder_frames"))
    loss = shard(xent_loss(logits, batch["labels"], batch.get("mask")))
    aux = shard(aux)                       # replicated scalars on a mesh
    total = loss + aux_weight * aux
    return total, {"xent": loss, "moe_aux": aux}
