"""Work of the XR nets, counted from the benchmark's own layer plan.

  * ``macs_per_image``: multiply-accumulates of one image's forward over
    the conv, depthwise and dense steps (the model's arithmetic; BN,
    activations and pooling are left out);
  * ``model_flops``: 2 x MACs an image for inference, 3 x that for a
    training step (forward, input gradient, weight gradient);
  * ``dw_launches``: (B, H, W, C) of each launch of the port's depthwise
    kernel a forward makes: every stride-1 3x3 depthwise step;
  * ``dw_bytes``: the least bytes a launch must move, each input byte read
    once and each output byte written once (float32): forward and input
    gradient read x (or dy) and the 3x3 weights and write y (or dx); the
    weight gradient reads x and dy and writes the 3x3 weights.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

from portbench.reference import xr as ref

F32 = 4


def macs_per_image(cfg: Mapping) -> int:
    total = [0]

    def visit(st: ref.Step, src):
        oh, ow = max(1, src[0] // st.stride), max(1, src[1] // st.stride)
        if st.op == "conv":
            total[0] += oh * ow * st.out_ch * src[2] * st.kernel ** 2
        elif st.op == "dwconv":
            total[0] += oh * ow * st.out_ch * st.kernel ** 2
        elif st.op == "dense":
            total[0] += src[2] * st.out_ch

    ref.walk(cfg, visit)
    return total[0]


def model_flops(cfg: Mapping, kind: str) -> int:
    """FLOPs an item (image): ``kind`` "train" or "infer"."""
    fwd = 2 * macs_per_image(cfg)
    return {"train": 3 * fwd, "infer": fwd}[kind]


def dw_launches(cfg: Mapping, batch: int) -> List[Tuple[int, int, int, int]]:
    shapes = []

    def visit(st: ref.Step, src):
        if st.op == "dwconv" and st.stride == 1 and st.kernel == 3:
            shapes.append((batch, src[0], src[1], src[2]))

    ref.walk(cfg, visit)
    return shapes


def dw_bytes(shape: Tuple[int, int, int, int], which: str) -> int:
    """Least bytes of one launch: ``which`` "fwd", "dx" or "wgrad"; each
    moves two activation tensors and the 3x3 weights once."""
    if which not in ("fwd", "dx", "wgrad"):
        raise ValueError(f"no depthwise launch {which!r}")
    b, h, w, c = shape
    return (2 * b * h * w * c + 9 * c) * F32


def dw_bytes_per_unit(cfg: Mapping, batch: int, kind: str) -> int:
    """Least bytes of the depthwise launches of one training step
    (forward, input and weight gradients) or one inference batch."""
    parts = ("fwd", "dx", "wgrad") if kind == "train" else ("fwd",)
    return sum(dw_bytes(s, p) for s in dw_launches(cfg, batch) for p in parts)


def dw_launches_per_unit(cfg: Mapping, kind: str) -> Tuple[int, int]:
    """(launches of the forward kernel, of the weight-gradient kernel)
    in one step or batch: the input gradient runs the forward kernel."""
    n = len(dw_launches(cfg, 1))
    return (2 * n, n) if kind == "train" else (n, 0)
