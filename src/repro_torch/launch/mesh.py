"""Production meshes and per-(arch x shape) input specs, port of
``repro.launch.mesh`` on ``torch.distributed``'s ``DeviceMesh``.

The meshes are built by FUNCTIONS from the live process group (importing
this module touches no distributed state): the reference's production
shapes (16, 16) ("data", "model") and (2, 16, 16) ("pod", "data", "model"),
so that specs compare one to one, and an elastic mesh over however many
ranks are alive. Input specs are meta tensors (no allocation) in place of
the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.models.params import abstract, logical_axes


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(mesh shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over the process group's 256 (512) ranks;
    ``init_device_mesh`` raises on any other world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_shape_from_ranks(n: int, model_parallel: int = 16
                          ) -> Tuple[int, int]:
    """(data, model) of the elastic mesh over n ranks: the model axis is
    gcd(model_parallel, n), as the reference's ``make_mesh_from_devices``."""
    mp = math.gcd(model_parallel, n)
    return n // mp, mp


def make_mesh_from_ranks(world_size: Optional[int] = None,
                         model_parallel: int = 16,
                         device_type: str = "cuda"):
    """Elastic variant: a ("data", "model") mesh over whatever ranks the
    process group holds (``world_size``, if given, must be its size)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    if world_size is not None and world_size != n:
        raise ValueError(f"make_mesh_from_ranks: asked for {world_size} "
                         f"ranks, the process group has {n}")
    return init_device_mesh(device_type, mesh_shape_from_ranks(
        n, model_parallel), mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """Model inputs for one assigned shape, as meta tensors.

    train/prefill: token batch (+ labels for train, + modality stubs);
    decode: one new token + positions (the KV cache is separate state,
    see ``decode_state_specs``)."""
    seq, batch, kind = SHAPES[shape_name]
    i32 = torch.int32
    if kind == "train":
        d = {"tokens": _meta((batch, seq), i32),
             "labels": _meta((batch, seq), i32)}
    elif kind == "prefill":
        d = {"tokens": _meta((batch, seq), i32)}
    else:                                     # decode: one token per row
        return {"tokens": _meta((batch, 1), i32),
                "position": _meta((batch,), i32)}
    if cfg.num_image_tokens:
        d["image_embeds"] = _meta((batch, cfg.num_image_tokens, cfg.d_model),
                                  torch.bfloat16)
    if cfg.encoder_layers:
        d["encoder_frames"] = _meta((batch, cfg.num_encoder_frames,
                                     cfg.d_model), torch.bfloat16)
    return d


def input_axes(cfg: ModelConfig, shape_name: str) -> Dict:
    """Logical axes for every input (resolved against mesh rules)."""
    _, _, kind = SHAPES[shape_name]
    if kind == "decode":
        return {"tokens": ("batch", None), "position": ("batch",)}
    d = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if kind == "prefill":
        d.pop("labels")
    if cfg.num_image_tokens:
        d["image_embeds"] = ("batch", None, "embed")
    if cfg.encoder_layers:
        d["encoder_frames"] = ("batch", None, "embed")
    return d


def decode_state_specs(cfg: ModelConfig, shape_name: str):
    """(meta cache, cache logical axes) for decode shapes."""
    seq, batch, kind = SHAPES[shape_name]
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} shape, not decode")
    defs = lm.cache_defs(cfg, batch, seq)
    return abstract(defs), logical_axes(defs)


def shape_rules(cfg: ModelConfig, shape_name: str) -> Optional[Dict]:
    """Per-shape sharding-rule overrides.

    long_500k has global_batch=1: batch axes are useless, so the KV cache /
    SSD state shard their LONG axes over the data(+pod) axes instead.
    Decode with kv_heads not divisible by the 16-way model axis switches the
    cache to sequence-parallel (kv_seq over 'model'); the head partition is
    dropped by fix_divisibility."""
    if shape_name == "long_500k":
        return {"batch": None, "kv_seq": ("pod", "data"),
                "heads": ("model",), "seq": None}
    _, _, kind = SHAPES[shape_name]
    if kind == "decode" and cfg.num_kv_heads and cfg.num_kv_heads % 16 != 0:
        return {"kv_seq": "model"}
    return None


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic useful FLOPs per step: 6·N·D train, 2·N·D fwd-only
    (N = active params for MoE)."""
    seq, batch, kind = SHAPES[shape_name]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch                   # decode: one token per row
