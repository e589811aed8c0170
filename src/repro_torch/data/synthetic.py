"""Deterministic synthetic datasets (numpy), an own copy of
``repro.data.synthetic``: the same (seed, index) gives the same arrays.

  * FPHAB-style  -- egocentric frames with two rendered "hands" (bright
    blobs); labels are 21-keypoint clouds reduced to bounding circles
    (center = keypoint mean, radius = max distance).
  * OpenEDS-style -- near-IR eye images built from nested ellipses with
    4-class masks (background / sclera / iris / pupil).
  * LM tokens    -- a Zipfian next-token stream (tokens + shifted labels).

Generators are pure functions of (seed, index).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def _render_hand(img, cx, cy, r, rng):
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / max(r, 1.0) ** 2
    blob = np.exp(-2.5 * d2)
    for c in range(img.shape[2]):
        img[:, :, c] += blob * rng.uniform(0.4, 0.9)


def fphab_sample(seed: int, idx: int, hw: Tuple[int, int], channels: int = 3
                 ) -> Dict[str, np.ndarray]:
    """One frame + circle annotations derived from synthetic 21-keypoints."""
    rng = np.random.default_rng((seed, idx))
    h, w = hw
    img = rng.normal(0.1, 0.05, (h, w, channels)).astype(np.float32)
    centers, radii = [], []
    for _ in range(2):                       # two hands
        kp = rng.normal(0, 0.08, (21, 2)) + rng.uniform(0.25, 0.75, (1, 2))
        kp = np.clip(kp, 0.02, 0.98) * [w, h]
        center = kp.mean(axis=0)             # paper: mean of keypoints
        radius = np.max(np.linalg.norm(kp - center, axis=1))
        _render_hand(img, center[0], center[1], radius, rng)
        centers.append(center / [w, h])      # normalized
        radii.append(radius / max(h, w))
    label = rng.integers(0, 2)               # left/right tracked hand
    return dict(image=np.clip(img, 0, 1),
                center=np.asarray(centers, np.float32),
                radius=np.asarray(radii, np.float32),
                label=np.int32(label))


def fphab_batches(batch: int, hw=(128, 128), channels=3, seed=0,
                  start_idx: int = 0) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    idx = start_idx
    while True:
        samples = [fphab_sample(seed, idx + i, hw, channels)
                   for i in range(batch)]
        idx += batch
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}, idx


def openeds_sample(seed: int, idx: int, hw: Tuple[int, int]
                   ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed + 1, idx))
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = w * rng.uniform(0.35, 0.65), h * rng.uniform(0.35, 0.65)
    ang = rng.uniform(-0.3, 0.3)
    ca, sa = np.cos(ang), np.sin(ang)
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca

    # nested ellipses: sclera > iris > pupil
    sc_a, sc_b = w * rng.uniform(0.30, 0.42), h * rng.uniform(0.18, 0.3)
    ir = min(sc_a, sc_b) * rng.uniform(0.45, 0.6)
    pu = ir * rng.uniform(0.3, 0.5)
    d_sc = (u / sc_a) ** 2 + (v / sc_b) ** 2
    d_ir = (u ** 2 + v ** 2) / ir ** 2
    d_pu = (u ** 2 + v ** 2) / pu ** 2
    mask = np.zeros((h, w), np.int32)
    mask[d_sc < 1] = 1
    mask[d_ir < 1] = 2
    mask[d_pu < 1] = 3

    img = 0.45 + 0.1 * rng.standard_normal((h, w, 1)).astype(np.float32)
    img[mask == 1] += 0.25
    img[mask == 2] -= 0.15
    img[mask == 3] -= 0.35
    return dict(image=np.clip(img, 0, 1).astype(np.float32), mask=mask)


def openeds_batches(batch: int, hw=(384, 640), seed=0, start_idx: int = 0
                    ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    idx = start_idx
    while True:
        samples = [openeds_sample(seed, idx + i, hw) for i in range(batch)]
        idx += batch
        yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}, idx


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def token_batches(batch: int, seq_len: int, vocab: int, seed=0,
                  start_idx: int = 0) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Zipfian next-token stream: tokens + shifted labels."""
    idx = start_idx
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    while True:
        rng = np.random.default_rng((seed + 2, idx))
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs)
        idx += batch
        yield dict(tokens=toks[:, :-1].astype(np.int32),
                   labels=toks[:, 1:].astype(np.int32)), idx
