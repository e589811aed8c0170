"""INT8 gradient compression with error feedback, port of
``repro.train.compress``.

Before a data-parallel all-reduce each leaf is quantized to int8 with one
scale per leaf; the quantization residual is carried to the next step
(error feedback), so nothing of the gradient is lost over steps. Cuts the
all-reduce's bytes 4x against f32. Sharded gradients (DTensors) keep
one scale per leaf, its max reduced across the shards.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.sharding import replicating

f32 = torch.float32
Tensors = Dict[str, torch.Tensor]


def init_error(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()}


def compress(grads: Tensors, error: Tensors
             ) -> Tuple[Tensors, Tensors, Tensors]:
    """-> (int8 codes, 0-dim f32 scales, new error). Apply before the
    mean-reduce. ``round`` is half to even, as ``jnp.round``; the scale is
    a true division."""
    q, s, e = {}, {}, {}
    with replicating(grads.values()):
        for k, g in grads.items():
            gf = g.to(f32) + error[k]
            sk = torch.clamp_min(gf.abs().amax(), 1e-12) / torch.tensor(
                127.0, dtype=f32, device=gf.device)
            qk = torch.clamp(torch.round(gf / sk), -127, 127).to(torch.int8)
            q[k], s[k], e[k] = qk, sk, gf - qk.to(f32) * sk
    return q, s, e


def decompress(q: Tensors, s: Tensors) -> Tensors:
    with replicating(q.values()):
        return {k: q[k].to(f32) * s[k] for k in q}
