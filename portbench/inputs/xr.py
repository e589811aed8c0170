"""The XR cells' inputs, made from the run's seed: weights, BN state and
images with their targets. The same seed gives the same inputs, and both
the program and the reference are handed them.

Weights are drawn on the run's device by one generator in one call, then
cut into the leaves of the benchmark's own layer plan under the port's
state-dict names (``<step>.<leaf>``): He-normal convs, depthwise and dense
weights at 1 / sqrt(fan-in), zero biases, BN scales 1 and shifts 0, BN
state mean 0 and variance 1.

Images are a frozen copy of the renderers of the port's synthetic data
(FPHAB-style frames with two hands and their bounding circles, OpenEDS-
style near-IR eyes with 4-class masks): each sample's shape parameters
come from ``numpy.random.default_rng((seed, index))`` as there, and the
pixels are rendered a batch at a time on the device, with the sensor
noise drawn there.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from portbench.reference import xr as ref

# stream tags: one independent generator per purpose
WEIGHTS, NOISE = 1, 2


def stream_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit generator seed for (seed, tag, index); any whole seed."""
    words = np.random.SeedSequence([seed % 2 ** 64, tag, index]) \
        .generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Parameters and BN state of ``cfg``'s net, float32, on ``device``."""
    shapes = ref.leaf_shapes(cfg)
    drawn = [k for k, (_, kind) in shapes.items()
             if kind in ("conv", "dwconv", "dense_w")]
    n = sum(math.prod(shapes[k][0]) for k in drawn)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS))
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, (shape, kind) in shapes.items():
        if k in drawn:
            size = math.prod(shape)
            fan_in = math.prod(shape[1:])
            std = math.sqrt(2.0 / fan_in) if kind == "conv" \
                else 1.0 / math.sqrt(fan_in)
            out[k] = flat[at:at + size].view(shape) * std
            at += size
        elif kind in ("bn_scale", "var"):
            out[k] = torch.ones(shape, device=device)
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def _noise(seed: int, index: int, shape, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(
        stream_seed(seed, NOISE, index))
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


def fphab(cfg: Mapping, seed: int, start: int, n: int, device
          ) -> Dict[str, torch.Tensor]:
    """Samples ``start`` .. ``start + n - 1`` of the hand-detection data:
    image (n, H, W, C) in [0, 1], center (n, 2, 2) and radius (n, 2)
    normalized, label (n,) int32."""
    h, w = cfg["input_hw"]
    c = cfg["in_channels"]
    cx, cy, rad, gain, centers, radii, labels = [], [], [], [], [], [], []
    for i in range(start, start + n):
        rng = np.random.default_rng((seed % 2 ** 64, i))
        cs, rs = [], []
        for _ in range(2):                         # two hands
            kp = rng.normal(0, 0.08, (21, 2)) + rng.uniform(0.25, 0.75, (1, 2))
            kp = np.clip(kp, 0.02, 0.98) * [w, h]
            center = kp.mean(axis=0)               # the keypoints' mean
            radius = np.max(np.linalg.norm(kp - center, axis=1))
            cs.append(center)
            rs.append(radius)
            gain.append(rng.uniform(0.4, 0.9, c))
        labels.append(rng.integers(0, 2))
        cx.append([p[0] for p in cs])
        cy.append([p[1] for p in cs])
        rad.append(rs)
        centers.append([p / [w, h] for p in cs])
        radii.append([r / max(h, w) for r in rs])

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    cxt, cyt = dev(cx)[:, :, None, None], dev(cy)[:, :, None, None]
    rt = torch.clamp_min(dev(rad), 1.0)[:, :, None, None]
    blob = torch.exp(-2.5 * ((xx - cxt) ** 2 + (yy - cyt) ** 2) / rt ** 2)
    g = dev(gain).reshape(n, 2, 1, 1, c)
    img = 0.1 + 0.05 * _noise(seed, start, (n, h, w, c), device)
    img = img + (blob[..., None] * g).sum(dim=1)
    return {"image": img.clamp(0, 1), "center": dev(centers),
            "radius": dev(radii), "label": dev(labels, torch.int32)}


def openeds(cfg: Mapping, seed: int, start: int, n: int, device
            ) -> Dict[str, torch.Tensor]:
    """Samples ``start`` .. ``start + n - 1`` of the eye-segmentation data:
    image (n, H, W, 1) in [0, 1], mask (n, H, W) int32 (background,
    sclera, iris, pupil)."""
    h, w = cfg["input_hw"]
    p = []
    for i in range(start, start + n):
        rng = np.random.default_rng((seed % 2 ** 64 + 1, i))
        cx, cy = w * rng.uniform(0.35, 0.65), h * rng.uniform(0.35, 0.65)
        ang = rng.uniform(-0.3, 0.3)
        sc_a, sc_b = w * rng.uniform(0.30, 0.42), h * rng.uniform(0.18, 0.3)
        ir = min(sc_a, sc_b) * rng.uniform(0.45, 0.6)
        pu = ir * rng.uniform(0.3, 0.5)
        p.append((cx, cy, math.cos(ang), math.sin(ang), sc_a, sc_b, ir, pu))
    p = torch.as_tensor(p, dtype=torch.float32, device=device)[:, :, None, None]
    cx, cy, ca, sa, sc_a, sc_b, ir, pu = p.unbind(1)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca
    mask = torch.zeros((n, h, w), dtype=torch.int32, device=device)
    mask[(u / sc_a) ** 2 + (v / sc_b) ** 2 < 1] = 1      # sclera
    mask[(u ** 2 + v ** 2) / ir ** 2 < 1] = 2            # iris
    mask[(u ** 2 + v ** 2) / pu ** 2 < 1] = 3            # pupil
    shift = torch.tensor([0.0, 0.25, -0.15, -0.35], device=device)[mask.long()]
    img = 0.45 + 0.1 * _noise(seed, start, (n, h, w), device) + shift
    return {"image": img.clamp(0, 1)[..., None], "mask": mask}


SAMPLES = {"detection": fphab, "segmentation": openeds}


def batches(cfg: Mapping, seed: int, start: int, count: int, size: int,
            device) -> List[Dict[str, torch.Tensor]]:
    """``count`` batches of ``size`` samples from sample ``start`` on."""
    make = SAMPLES[cfg["task"]]
    return [make(cfg, seed, start + i * size, size, device)
            for i in range(count)]


def to_host(batch: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in batch.items()}
