"""Optimizers written out (no ``torch.optim``): AdamW, SGD-momentum, global
norm clipping and the cosine schedule, port of ``repro.train.optim``.

Plain functions on dicts of tensors, in the reference's order of
operations: ``torch.optim.AdamW`` has other defaults (b2 = 0.999) and
applies weight decay before the Adam step, the reference after it (to
every leaf, biases and BN included), so the port writes the update out.
The state is a NamedTuple of dicts (m, v, count) with f32 moments and an
int32 count, which checkpoints under the reference's keys. Scalar divisors
are 0-dim f32 tensors, so every division is a true f32 division on every
device (a Python float divisor on a CUDA tensor becomes a multiply by its
reciprocal).

Sharded parameters (DTensors): the moments take each parameter's
placements (``zeros_like``), the 0-dim constants are taken as replicated
beside them (``sharding.replicating``), and the global norm's sums reduce
across the shards. On one device the numbers are those of plain tensors.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.sharding import replicating

f32 = torch.float32
Tensors = Dict[str, torch.Tensor]


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=f32, device=like.device)


class AdamWState(NamedTuple):
    m: Tensors
    v: Tensors
    count: torch.Tensor          # 0-dim int32


def adamw_init(params: Tensors) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()}
    dev = next(iter(params.values())).device if params else "cpu"
    return AdamWState(zeros, {k: z.clone() for k, z in zeros.items()},
                      torch.zeros((), dtype=torch.int32, device=dev))


def adamw_update(grads: Tensors, state: AdamWState, params: Tensors, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01
                 ) -> Tuple[Tensors, AdamWState]:
    """One AdamW step: returns (new params, new state); nothing is updated
    in place. ``lr`` is a Python float or a 0-dim f32 tensor."""
    c = state.count + 1
    cf = c.to(f32)
    bc1 = 1 - b1 ** cf
    bc2 = 1 - b2 ** cf
    new_p, new_m, new_v = {}, {}, {}
    with replicating(params.values()):
        for k, p in params.items():
            g = grads[k].to(f32)
            m2 = b1 * state.m[k] + (1 - b1) * g
            v2 = b2 * state.v[k] + (1 - b2) * g * g
            step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            step = step + weight_decay * p.to(f32)
            new_p[k] = (p.to(f32) - lr * step).to(p.dtype)
            new_m[k], new_v[k] = m2, v2
    return new_p, AdamWState(new_m, new_v, c)


class SGDState(NamedTuple):
    mom: Tensors
    count: torch.Tensor


def sgd_init(params: Tensors) -> SGDState:
    dev = next(iter(params.values())).device if params else "cpu"
    return SGDState({k: torch.zeros_like(p, dtype=f32)
                     for k, p in params.items()},
                    torch.zeros((), dtype=torch.int32, device=dev))


def sgd_update(grads: Tensors, state: SGDState, params: Tensors, *, lr,
               momentum=0.9) -> Tuple[Tensors, SGDState]:
    new_p, new_m = {}, {}
    with replicating(params.values()):
        for k, p in params.items():
            m2 = momentum * state.mom[k] + grads[k].to(f32)
            new_p[k] = (p.to(f32) - lr * m2).to(p.dtype)
            new_m[k] = m2
    return new_p, SGDState(new_m, state.count + 1)


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, the leaves' sums added
    in order, in f32 (over sharded leaves each sum is reduced across the
    shards; the result is replicated)."""
    sq = sum(torch.sum(torch.square(t.to(f32))) for t in tree.values())
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm); returns (clipped,
    norm)."""
    n = global_norm(grads)
    with replicating(grads.values()):
        scale = torch.clamp(_scalar(max_norm, n) / torch.clamp_min(n, 1e-9),
                            max=1.0)
        return {k: (g.to(f32) * scale).to(g.dtype)
                for k, g in grads.items()}, n


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[int], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a half
    cosine to 0 at ``total``; lr(step) is a 0-dim f32 CPU tensor."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(f32).cpu()
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
