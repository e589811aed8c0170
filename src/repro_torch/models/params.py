"""Structural parameter definitions and the bridge to JAX parameter trees.

Models declare their parameters as a tree (nested dicts) of ``ParamDef``,
in the JAX package's layout and with its initializers, so a port and a
reference model built from one config have the same shapes and the same
init distributions. ``jax.random`` bits cannot be reproduced in torch, so
tests carry a JAX tree across with ``from_jax`` instead.

Layouts: for the XR nets the JAX package stores convs HWIO, depthwise
weights (k,k,1,C) and dense weights (in,out); the port stores OIHW,
(C,1,k,k) and (out,in). One permutation serves convs and depthwise weights
alike (HWIO -> OIHW maps (k,k,1,C) to (C,1,k,k)), so ``from_jax``/``to_jax``
need no config. The LM trees keep the JAX layout as it is (stacked
``(R, in, out)`` weights used as ``x @ w``, the embedding ``(V, D)``), so
``lm_from_jax``/``lm_to_jax`` copy leaves and change nothing but the type.
bfloat16 crosses as its 16 bits, so every round trip is bit-exact.
``xr_train_to_jax``/``xr_train_from_jax`` map the XR training tree
(parameters, BN state, AdamW moments and count) to and from the tree the
reference checkpoints, so checkpoints cross between the packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

STATE_LEAVES = ("mean", "var")       # BN running stats: buffers, not params


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axes, len == len(shape)
    init: str = "normal"          # normal | zeros | ones | scaled | arange_neg
    dtype: str = "bfloat16"
    scale: float = 1.0                 # stddev multiplier for normal/scaled

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_CHUNK = 1 << 28      # f32 elements drawn at once on a card


def _normal(shape, std: float, dt: torch.dtype,
            generator: torch.Generator) -> torch.Tensor:
    """N(0, std^2) in ``dt``, drawn in f32 by ``generator`` on its device.
    On a card, leaves over _CHUNK elements are drawn in slices of their
    leading dim, so the f32 draw never holds more than 1 GiB beside the
    weights (a stacked Yi-34B MLP leaf is 8.8 G elements)."""
    dev = generator.device
    n = int(np.prod(shape))
    if dev.type == "cpu" or n <= _CHUNK or len(shape) < 2:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev).mul_(std).to(dt)
    t = torch.empty(shape, dtype=dt, device=dev)
    rows = max(1, _CHUNK // (n // shape[0]))
    for r in range(0, shape[0], rows):
        part = t[r:r + rows]
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=dev).mul_(std))
    return t


def materialize(defs, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Dict:
    """Initialize a ParamDef tree as tensors (same nesting) on ``device``.

    Draws come from ``generator`` in sorted key order: a CPU generator gives
    the same weights on every device; a generator on ``device`` (a card)
    draws there, without the host round trip, which is what makes
    full-width models of tens of billions of parameters quick to make (its
    numbers differ from a CPU generator's)."""
    dev = resolve_device(device)
    if generator.device.type != "cpu" and generator.device != dev:
        raise ValueError(f"materialize draws on the CPU or on {dev}: the "
                         f"generator is on {generator.device}")
    gdev = generator.device
    out: Dict = {}
    for path, d in _leaves(defs):
        dt = getattr(torch, d.dtype)
        if d.init == "zeros":
            t = torch.zeros(d.shape, dtype=dt, device=gdev)
        elif d.init == "ones":
            t = torch.ones(d.shape, dtype=dt, device=gdev)
        elif d.init == "arange_neg":   # mamba A_log init: log(1..n)
            t = torch.log(torch.arange(1, d.shape[-1] + 1,
                                       dtype=torch.float32)).to(gdev, dt)
            t = t * torch.ones(d.shape, dtype=dt, device=gdev)
        elif d.init in ("normal", "scaled"):
            fan_in = d.shape[0] if len(d.shape) > 1 else max(1, d.shape[-1])
            std = (d.scale / np.sqrt(fan_in) if d.init == "scaled"
                   else 0.02 * d.scale)
            t = _normal(d.shape, std, dt, generator)
        else:
            raise ValueError(f"unknown init {d.init!r} at {'.'.join(path)}")
        _set(out, path, t.to(dev))
    return out


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the numpy or JAX array ``a``; a
    bfloat16 array crosses as its 16 bits (numpy has no bfloat16 of its own,
    so ``torch.from_numpy`` refuses one)."""
    if torch.is_tensor(a):
        return a.detach().cpu().clone()
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t``; bfloat16 becomes ``ml_dtypes.bfloat16`` (the
    type JAX arrays convert to), bit for bit."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _to_port(a) -> torch.Tensor:
    t = _tensor(a)
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
    if t.dim() == 2:
        return t.t().contiguous()                      # (in,out) -> (out,in)
    return t


def _to_jax(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dim() == 4:
        t = t.permute(2, 3, 1, 0)                      # OIHW -> HWIO
    elif t.dim() == 2:
        t = t.t()
    return _array(t)


def from_jax(params, state) -> Dict[str, torch.Tensor]:
    """JAX (params, bn_state) trees of arrays -> the port's state dict,
    keyed ``<step>.<leaf>`` (CPU tensors in the port's layout)."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, state):
        for path, a in _leaves(tree):
            sd[".".join(path)] = _to_port(a)
    return sd


def to_jax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Inverse of ``from_jax``: numpy (params, bn_state) trees in the JAX
    package's layout."""
    params: Dict = {}
    state: Dict = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        _set(state if path[-1] in STATE_LEAVES else params, path, _to_jax(t))
    return params, state


def _map_defs(fn, defs) -> Dict:
    return {k: _map_defs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in defs.items()}


def abstract(defs) -> Dict:
    """The ParamDef tree as meta tensors of its shapes and dtypes (what the
    dry-run traces; nothing is allocated)."""
    return _map_defs(lambda d: torch.empty(d.shape, dtype=getattr(torch,
                                                                  d.dtype),
                                           device="meta"), defs)


def logical_axes(defs) -> Dict:
    """The ParamDef tree's logical axes, one tuple per leaf."""
    return _map_defs(lambda d: d.axes, defs)


def flatten(tree) -> Dict[str, torch.Tensor]:
    """A nested dict of leaves -> {"a.b.c": leaf}, in sorted key order (the
    reference's tree order, so sums over the leaves run in its order)."""
    return {".".join(path): leaf for path, leaf in _leaves(tree)}


def unflatten(flat: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of ``flatten``."""
    out: Dict = {}
    for key, leaf in flat.items():
        _set(out, tuple(key.split(".")), leaf)
    return out


def lm_from_jax(params) -> Dict:
    """A JAX LM parameter (or cache) tree -> the same nesting of CPU
    tensors, in the same layout and dtype."""
    out: Dict = {}
    for path, a in _leaves(params):
        _set(out, path, _tensor(a))
    return out


def lm_to_jax(tree) -> Dict:
    """Inverse of ``lm_from_jax``: the same nesting of numpy arrays, ready
    for ``jnp.asarray``."""
    out: Dict = {}
    for path, t in _leaves(tree):
        _set(out, path, _array(t))
    return out


def xr_train_to_jax(state_dict: Mapping[str, torch.Tensor],
                    m: Mapping[str, torch.Tensor],
                    v: Mapping[str, torch.Tensor], count) -> Dict:
    """The XR training tree as ``repro.train.loop`` checkpoints it:
    {"params", "state", "opt": {"m", "v", "count"}}, numpy in the JAX
    layouts. ``m``/``v`` are the AdamW moments keyed like the net's
    parameters; the reference's ``AdamWState`` fields flatten to the same
    ``k:m``/``k:v``/``k:count`` keys as this dict's."""
    params, state = to_jax(state_dict)
    return {"params": params, "state": state,
            "opt": {"m": to_jax(m)[0], "v": to_jax(v)[0],
                    "count": _array(torch.as_tensor(count))}}


def xr_train_from_jax(tree) -> Tuple[Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor],
                                     Dict[str, torch.Tensor], torch.Tensor]:
    """Inverse of ``xr_train_to_jax``: (state dict, m, v, count), CPU
    tensors in the port's layouts."""
    opt = tree["opt"]
    return (from_jax(tree["params"], tree["state"]), from_jax(opt["m"], {}),
            from_jax(opt["v"], {}), _tensor(opt["count"]))
