"""Plain PyTorch reference of the paper's XR nets, DetNet and EDSNet.

Written afresh from the paper (arXiv 2206.06780, Fig 1d and 1e) and the
layer plan of the JAX package's ``models/xr.py``, with no kernel of the
port and nothing imported from it. Everything is float32 with TF32 off
(the caller sets the backend flags; ``tf32`` here only names them).

  * ``build_plan`` / ``walk``: the MobileNetV2 trunk, DetNet's three
    regression heads, EDSNet's UNet decoder, as a flat list of steps;
  * ``forward``: NCHW ``F.conv2d`` for every conv, the depthwise steps
    with ``groups=C``; batch norm in train mode (batch statistics, their
    EMA returned) or eval mode (the running statistics);
  * ``circle_loss``, ``dice_loss``; ``train_steps``: autograd through
    plain ops, the global-norm clip, AdamW with decoupled decay added
    after the Adam step; ``schedule_lr``: the linear warm-up and the
    cosine of the schedule; ``adamw_apply``: the update from given moments;
  * ``bn_stats``, ``quantize_weights``, ``int8_forward``: evaluation with
    per-channel symmetric INT8 fake-quant of the weights.

Parameters are a dict keyed ``<step>.<leaf>``: ``w`` (convs (O, I, k, k),
depthwise (C, 1, 3, 3), dense (out, in)), ``b`` (dense), ``bn_scale``,
``bn_bias``; the BN state ``<step>.mean`` and ``<step>.var``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
STATE_LEAVES = ("mean", "var")


@dataclass(frozen=True)
class Step:
    name: str
    op: str                  # conv | dwconv | dense | gpool | upsample | concat | add
    out_ch: int = 0
    kernel: int = 1
    stride: int = 1
    relu: bool = True        # relu6 after BN (convs), relu (dense)
    bn: bool = True
    src: str = "_"           # "_" = the running value, else a saved tensor
    skip: str = ""           # concat / add: the second tensor
    save_as: str = ""


def _ch(cfg: Mapping, c: int) -> int:
    wm = cfg["width_mult"]
    return c if wm == 1.0 else max(8, int(c * wm + 4) // 8 * 8)


def build_plan(cfg: Mapping) -> List[Step]:
    """The net as a list of steps; ``cfg`` is a configuration file's dict."""
    steps: List[Step] = [Step("stem", "conv", _ch(cfg, cfg["stem_channels"]),
                              3, 2)]
    in_ch = _ch(cfg, cfg["stem_channels"])
    stride_now, taps, bi = 2, {}, 0
    for t, c, n, s in cfg["stages"]:
        c = _ch(cfg, c)
        for r in range(n):
            stride = s if r == 0 else 1
            if stride == 2:          # the step before a downsample is a tap
                tap = f"tap_s{stride_now}"
                steps[-1] = replace(steps[-1], save_as=tap)
                taps[stride_now] = tap
                stride_now *= 2
            exp, res = t * in_ch, ""
            if stride == 1 and exp != in_ch and c == in_ch:
                res = f"irb{bi}_in"
                steps[-1] = replace(steps[-1], save_as=res)
            if t != 1:
                steps.append(Step(f"irb{bi}_expand", "conv", exp))
            steps.append(Step(f"irb{bi}_dw", "dwconv", exp, 3, stride))
            steps.append(Step(f"irb{bi}_project", "conv", c, relu=False))
            if res:
                steps.append(Step(f"irb{bi}_add", "add", skip=res))
            in_ch, bi = c, bi + 1
    if cfg["task"] == "detection":
        steps.append(Step("head_conv", "conv", _ch(cfg, cfg["head_channels"])))
        steps.append(Step("gpool", "gpool", save_as="gpool_out"))
        for head, dim in (("center", 4), ("radius", 2), ("label", 2)):
            steps.append(Step(f"{head}_fc1", "dense", 64, src="gpool_out"))
            steps.append(Step(f"{head}_out", "dense", dim, relu=False,
                              save_as=f"out_{head}"))
    else:
        for i, dc in enumerate(cfg["decoder_channels"]):
            stride_now //= 2
            steps.append(Step(f"dec{i}_up", "upsample"))
            if stride_now in taps:
                steps.append(Step(f"dec{i}_cat", "concat", skip=taps[stride_now]))
            steps.append(Step(f"dec{i}_conv1", "conv", dc, 3))
            steps.append(Step(f"dec{i}_conv2", "conv", dc, 3))
        steps.append(Step("seg_head", "conv", cfg["num_classes"], 3, relu=False,
                          bn=False, save_as="out_mask"))
    return steps


def walk(cfg: Mapping, visit: Callable[[Step, Tuple[int, int, int]], None]):
    """Shape inference over the plan: ``visit(step, (H, W, C) of its
    input)`` for every step; returns the last output's (H, W, C)."""
    h, w = cfg["input_hw"]
    cur, saved = (h, w, cfg["in_channels"]), {}
    for st in build_plan(cfg):
        src = cur if st.src == "_" else saved[st.src]
        visit(st, src)
        if st.op in ("conv", "dwconv"):
            cur = (max(1, src[0] // st.stride), max(1, src[1] // st.stride),
                   st.out_ch)
        elif st.op == "dense":
            cur = (1, 1, st.out_ch)
        elif st.op == "gpool":
            cur = (1, 1, src[2])
        elif st.op == "upsample":
            cur = (2 * src[0], 2 * src[1], src[2])
        elif st.op == "concat":
            cur = (src[0], src[1], src[2] + saved[st.skip][2])
        else:
            cur = src
        if st.save_as:
            saved[st.save_as] = cur
    return cur


def leaf_shapes(cfg: Mapping) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{``<step>.<leaf>``: (shape, kind)}, kind one of conv, dwconv,
    dense_w, dense_b, bn_scale, bn_bias, mean, var; fan-in is read from
    the shape."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def visit(st: Step, src):
        cin = src[2]
        if st.op == "conv":
            out[f"{st.name}.w"] = ((st.out_ch, cin, st.kernel, st.kernel), "conv")
        elif st.op == "dwconv":
            out[f"{st.name}.w"] = ((cin, 1, st.kernel, st.kernel), "dwconv")
        elif st.op == "dense":
            out[f"{st.name}.w"] = ((st.out_ch, cin), "dense_w")
            out[f"{st.name}.b"] = ((st.out_ch,), "dense_b")
        if st.op in ("conv", "dwconv") and st.bn:
            for leaf in ("bn_scale", "bn_bias", "mean", "var"):
                out[f"{st.name}.{leaf}"] = ((st.out_ch,), leaf)

    walk(cfg, visit)
    return out


def split(tensors: Mapping[str, torch.Tensor]) -> Tuple[Tensors, Tensors]:
    """A state dict -> (parameters, BN state)."""
    params = {k: v for k, v in tensors.items()
              if k.rsplit(".", 1)[1] not in STATE_LEAVES}
    state = {k: v for k, v in tensors.items()
             if k.rsplit(".", 1)[1] in STATE_LEAVES}
    return params, state


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(cfg: Mapping, params: Mapping[str, torch.Tensor],
            state: Mapping[str, torch.Tensor], images: torch.Tensor, *,
            train: bool) -> Tuple[Tensors, Tensors]:
    """images (B, H, W, Cin) -> (outputs {head: NHWC}, new BN state).
    ``train``: batch statistics, and the new state holds their EMA."""
    x = images.permute(0, 3, 1, 2)
    saved: Dict[str, torch.Tensor] = {}
    outputs: Dict[str, torch.Tensor] = {}
    new_state: Dict[str, torch.Tensor] = {}
    for st in build_plan(cfg):
        src = x if st.src == "_" else saved[st.src]
        if st.op in ("conv", "dwconv"):
            groups = src.shape[1] if st.op == "dwconv" else 1
            y = F.conv2d(src, params[f"{st.name}.w"], stride=st.stride,
                         padding=(st.kernel - 1) // 2, groups=groups)
            if st.bn:
                if train:
                    mean = y.mean(dim=(0, 2, 3))
                    var = ((y - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
                    for leaf, v in (("mean", mean), ("var", var)):
                        new_state[f"{st.name}.{leaf}"] = (
                            BN_MOMENTUM * state[f"{st.name}.{leaf}"]
                            + (1 - BN_MOMENTUM) * v)
                else:
                    mean, var = state[f"{st.name}.mean"], state[f"{st.name}.var"]
                inv = torch.rsqrt(var + BN_EPS) * params[f"{st.name}.bn_scale"]
                y = ((y - mean[:, None, None]) * inv[:, None, None]
                     + params[f"{st.name}.bn_bias"][:, None, None])
            if st.relu:
                y = torch.clamp(y, 0.0, 6.0)
        elif st.op == "dense":
            y = (src.reshape(src.shape[0], -1) @ params[f"{st.name}.w"].t()
                 + params[f"{st.name}.b"])
            if st.relu:
                y = torch.relu(y)
        elif st.op == "gpool":
            y = src.mean(dim=(2, 3), keepdim=True)
        elif st.op == "upsample":
            y = src.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif st.op == "concat":
            y = torch.cat([src, saved[st.skip]], dim=1)
        else:                                   # add
            y = src + saved[st.skip]
        x = y
        if st.save_as:
            saved[st.save_as] = y
            if st.save_as.startswith("out_"):
                outputs[st.save_as[4:]] = y.permute(0, 2, 3, 1) \
                    if y.dim() == 4 else y
    return outputs, new_state


# ---------------------------------------------------------------------------
# losses and training
# ---------------------------------------------------------------------------

def circle_loss(outputs, batch, center_weight: float = 10.0) -> torch.Tensor:
    """DetNet: weighted MSE on the circles' centers and radii, cross
    entropy on the hand label."""
    center = outputs["center"].reshape(-1, 2, 2)
    circle = (center_weight * ((center - batch["center"]) ** 2).mean()
              + ((outputs["radius"] - batch["radius"]) ** 2).mean())
    logp = torch.log_softmax(outputs["label"], dim=-1)
    ce = -logp.gather(-1, batch["label"].long()[:, None]).mean()
    return circle + ce


def dice_loss(outputs, batch, eps: float = 1.0) -> torch.Tensor:
    """EDSNet: 1 - mean soft Dice over the classes."""
    logits = outputs["mask"]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(batch["mask"].long(), logits.shape[-1]).to(probs.dtype)
    inter = (probs * onehot).sum(dim=(0, 1, 2))
    union = (probs + onehot).sum(dim=(0, 1, 2))
    return 1.0 - ((2 * inter + eps) / (union + eps)).mean()


LOSSES = {"detection": circle_loss, "segmentation": dice_loss}


def warmup_lr(base: float, step: int, warmup: int) -> float:
    """The cosine schedule inside its linear warm-up."""
    if step >= warmup:
        raise ValueError("use schedule_lr past the warm-up")
    return base * step / warmup


def schedule_lr(base: float, step: int, warmup: int, total: int) -> float:
    """The rate at ``step``: linear warm-up over ``warmup`` steps, then a
    half cosine to 0 at ``total``, worked in float32."""
    f = torch.float32
    s = torch.tensor(float(step), dtype=f)
    if step < warmup:
        return float(torch.tensor(base, dtype=f) * s / warmup)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return float(base * 0.5 * (1 + torch.cos(math.pi * prog)))


def adamw_apply(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int,
                lr: float, *, b1: float = 0.9, b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.01) -> torch.Tensor:
    """The parameter after the ``count``-th AdamW step from ``p``, with the
    moments ``m`` and ``v`` that step left: the bias-corrected Adam step,
    then the decoupled decay of ``p``."""
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    return p - lr * (upd + weight_decay * p)


def train_steps(cfg: Mapping, params: Mapping[str, torch.Tensor],
                state: Mapping[str, torch.Tensor], batches: Sequence[Mapping],
                lrs: Sequence[float], *, max_norm: float = 1.0,
                b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                weight_decay: float = 0.01, moments=None, count: int = 0):
    """Train-mode steps on ``batches`` (device tensors) at the rates
    ``lrs``, from the AdamW ``moments`` (m, v) after ``count`` steps, or
    from zero. Returns (losses, the first step's gradients as the
    optimizer gets them, after the clip, parameters after the last step,
    BN state after it)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s = {k: v.detach().clone() for k, v in state.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        m = {k: t.detach().clone() for k, t in moments[0].items()}
        v2 = {k: t.detach().clone() for k, t in moments[1].items()}
    loss_fn = LOSSES[cfg["task"]]
    losses, first = [], None
    for t, (batch, lr) in enumerate(zip(batches, lrs)):
        outs, new_s = forward(cfg, p, s, batch["image"], train=True)
        loss = loss_fn(outs, batch)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
            scale = min(1.0, max_norm / max(float(norm), 1e-9))
            grads = {k: g * scale for k, g in grads.items()}
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            for k in p:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                p[k].copy_(adamw_apply(p[k], m[k], v2[k], count + t + 1, lr,
                                       b1=b1, b2=b2, eps=eps,
                                       weight_decay=weight_decay))
        s = {k: t_.detach() for k, t_ in new_s.items()}
    return losses, first, {k: t.detach() for k, t in p.items()}, s


# ---------------------------------------------------------------------------
# post-training quantization
# ---------------------------------------------------------------------------

def quantize_weights(params: Mapping[str, torch.Tensor], bits: int) -> Tensors:
    """Fake-quantize every ``w`` leaf per output channel (axis 0) with
    symmetric min-max scales; other leaves pass through."""
    q = float(2 ** (bits - 1) - 1)
    out = {}
    for k, v in params.items():
        if k.endswith(".w"):
            amax = v.abs().reshape(v.shape[0], -1).amax(dim=1)
            s = (torch.clamp_min(amax, 1e-8) / q).reshape(-1, *[1] * (v.dim() - 1))
            out[k] = torch.clamp(torch.round(v / s), -q, q) * s
        else:
            out[k] = v
    return out


@torch.no_grad()
def bn_stats(cfg: Mapping, params: Mapping[str, torch.Tensor],
             state: Mapping[str, torch.Tensor], images: torch.Tensor) -> Tensors:
    """BN running statistics set to the batch statistics of ``images``
    (what a trained net's EMA holds on such data)."""
    zero = {k: torch.zeros_like(v) for k, v in state.items()}
    _, new_s = forward(cfg, params, zero, images, train=True)
    return {k: v / (1 - BN_MOMENTUM) for k, v in new_s.items()}


@torch.no_grad()
def int8_forward(cfg: Mapping, qparams: Mapping[str, torch.Tensor],
                 state: Mapping[str, torch.Tensor], images: torch.Tensor
                 ) -> Tensors:
    """The eval-mode forward with fake-quantized weights ``qparams``."""
    outs, _ = forward(cfg, qparams, state, images, train=False)
    return outs
