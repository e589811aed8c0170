"""The paper's XR workloads in PyTorch: MobileNetV2, DetNet, EDSNet.

Port of ``repro.models.xr``. The architecture is a *plan*, a flat list of
typed steps, and everything derives from it:

  * ``param_defs``        -- parameter + BN-state ParamDef trees (JAX layout),
  * ``XRNet``             -- an ``nn.Module`` that interprets the plan,
  * ``conv_layer_specs``  -- the per-layer workload descriptors of the DSE
    plane.

Images go in NHWC and outputs come out NHWC, as in the reference. Inside,
activations are NCHW tensors in ``channels_last`` memory (physically NHWC),
so every stride-1 3x3 depthwise step hands the CUDA depthwise kernel a
C-contiguous NHWC view with no copy. The other convs and the dense heads
stay on ``F.conv2d`` and ``torch.matmul``, as the reference keeps them on
``lax`` outside any Pallas kernel. On the card the depthwise kernel's
backward is kernels too (``kernels.depthwise_conv.DepthwiseConv3x3``), and
the ops between the kernels keep channels_last, so the output gradient
reaches it NHWC-contiguous. The paper's losses (``circle_loss``,
``dice_loss``) and ``iou`` take the NHWC outputs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ConvLayerSpec, XRConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.params import (STATE_LEAVES, ParamDef, from_jax,
                                       materialize)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Step:
    name: str
    op: str                  # conv | dwconv | dense | gpool | upsample | concat | add
    out_ch: int = 0
    kernel: int = 1
    stride: int = 1
    relu: bool = True        # relu6 after BN (convs) / relu after dense
    bn: bool = True          # conv steps: batchnorm
    src: str = "_"           # input tensor ("_" = running value)
    skip: str = ""           # concat/add: second tensor name
    save_as: str = ""        # store output under this tap name


def _ch(cfg: XRConfig, c: int) -> int:
    if cfg.width_mult == 1.0:
        return c
    return max(8, int(c * cfg.width_mult + 4) // 8 * 8)


def build_plan(cfg: XRConfig) -> List[Step]:
    """MobileNetV2 trunk (+ DetNet heads or UNet decoder)."""
    steps: List[Step] = []
    stride_now = 2
    steps.append(Step("stem", "conv", _ch(cfg, cfg.stem_channels), 3, 2))
    in_ch = _ch(cfg, cfg.stem_channels)
    taps: Dict[int, str] = {}     # stride -> tap name

    bi = 0
    for (t, c, n, s) in cfg.stages:
        c = _ch(cfg, c)
        for r in range(n):
            stride = s if r == 0 else 1
            if stride == 2:
                tap = f"tap_s{stride_now}"
                # retroactively mark the previous step to save its output
                steps[-1] = dataclasses.replace(steps[-1], save_as=tap)
                taps[stride_now] = tap
                stride_now *= 2
            pfx = f"irb{bi}"
            exp = t * in_ch
            res_src = ""
            if stride == 1 and exp != in_ch and c == in_ch:
                res_src = f"{pfx}_in"
                steps[-1] = dataclasses.replace(steps[-1], save_as=res_src)
            if t != 1:
                steps.append(Step(f"{pfx}_expand", "conv", exp, 1, 1))
            steps.append(Step(f"{pfx}_dw", "dwconv", exp, 3, stride))
            steps.append(Step(f"{pfx}_project", "conv", c, 1, 1, relu=False))
            if res_src:
                steps.append(Step(f"{pfx}_add", "add", skip=res_src))
            in_ch = c
            bi += 1

    if cfg.task == "detection":
        head = _ch(cfg, cfg.head_channels)
        steps.append(Step("head_conv", "conv", head, 1, 1))
        steps.append(Step("gpool", "gpool", save_as="gpool_out"))
        # three regression nets: circle center (2 hands x xy), radius (2),
        # left/right label logits (2)  [paper Fig 1d]
        for hname, hdim in (("center", 4), ("radius", 2), ("label", 2)):
            steps.append(Step(f"{hname}_fc1", "dense", 64, src="gpool_out"))
            steps.append(Step(f"{hname}_out", "dense", hdim, relu=False,
                              save_as=f"out_{hname}"))
    else:
        # UNet decoder [paper Fig 1e: "segmentation models" MBv2-UNet]
        for i, dc in enumerate(cfg.decoder_channels):
            stride_now //= 2
            steps.append(Step(f"dec{i}_up", "upsample"))
            if stride_now in taps:
                steps.append(Step(f"dec{i}_cat", "concat", skip=taps[stride_now]))
            steps.append(Step(f"dec{i}_conv1", "conv", dc, 3, 1))
            steps.append(Step(f"dec{i}_conv2", "conv", dc, 3, 1))
        steps.append(Step("seg_head", "conv", cfg.num_classes, 3, 1,
                          relu=False, bn=False, save_as="out_mask"))
    return steps


def uses_depthwise_kernel(st: Step) -> bool:
    """The steps that run the CUDA depthwise kernel: stride-1 3x3 dwconv."""
    return st.op == "dwconv" and st.stride == 1 and st.kernel == 3


# ---------------------------------------------------------------------------
# shape walking (shared by param_defs and the DSE extractor)
# ---------------------------------------------------------------------------

def _walk(cfg: XRConfig, visit):
    """Run shape inference over the plan, calling visit(step, in_hwc)."""
    h, w = cfg.input_hw
    shapes: Dict[str, Tuple[int, int, int]] = {}
    cur = (h, w, cfg.in_channels)
    for st in build_plan(cfg):
        src = cur if st.src == "_" else shapes[st.src]
        visit(st, src)
        if st.op in ("conv", "dwconv"):
            out = (max(1, src[0] // st.stride), max(1, src[1] // st.stride),
                   st.out_ch)
        elif st.op == "dense":
            out = (1, 1, st.out_ch)
        elif st.op == "gpool":
            out = (1, 1, src[2])
        elif st.op == "upsample":
            out = (src[0] * 2, src[1] * 2, src[2])
        elif st.op == "concat":
            other = shapes[st.skip]
            out = (src[0], src[1], src[2] + other[2])
        elif st.op == "add":
            out = src
        else:
            raise ValueError(st.op)
        cur = out
        if st.save_as:
            shapes[st.save_as] = out
    return cur


def param_defs(cfg: XRConfig) -> Tuple[Dict, Dict]:
    """Returns (params, bn_state) ParamDef trees, in the JAX layout."""
    params: Dict[str, Dict] = {}
    state: Dict[str, Dict] = {}

    def visit(st: Step, src):
        cin = src[2]
        if st.op == "conv":
            params[st.name] = {"w": ParamDef(
                (st.kernel, st.kernel, cin, st.out_ch),
                (None, None, "conv", "conv"), "scaled", "float32")}
        elif st.op == "dwconv":
            params[st.name] = {"w": ParamDef(
                (st.kernel, st.kernel, 1, cin),
                (None, None, None, "conv"), "scaled", "float32", scale=3.0)}
        elif st.op == "dense":
            params[st.name] = {
                "w": ParamDef((cin, st.out_ch), ("conv", "conv"),
                              "scaled", "float32"),
                "b": ParamDef((st.out_ch,), ("conv",), "zeros", "float32")}
        if st.op in ("conv", "dwconv") and st.bn:
            C = st.out_ch
            params[st.name]["bn_scale"] = ParamDef((C,), ("conv",), "ones",
                                                   "float32")
            params[st.name]["bn_bias"] = ParamDef((C,), ("conv",), "zeros",
                                                  "float32")
            state[st.name] = {
                "mean": ParamDef((C,), ("conv",), "zeros", "float32"),
                "var": ParamDef((C,), ("conv",), "ones", "float32")}

    _walk(cfg, visit)
    return params, state


def conv_layer_specs(cfg: XRConfig) -> List[ConvLayerSpec]:
    """Workload descriptors for the DSE plane (one per MAC-bearing step)."""
    out: List[ConvLayerSpec] = []

    def visit(st: Step, src):
        if st.op == "conv":
            out.append(ConvLayerSpec(st.name, "conv", src[2], st.out_ch,
                                     st.kernel, st.stride, (src[0], src[1])))
        elif st.op == "dwconv":
            out.append(ConvLayerSpec(st.name, "dwconv", src[2], st.out_ch,
                                     st.kernel, st.stride, (src[0], src[1])))
        elif st.op == "dense":
            out.append(ConvLayerSpec(st.name, "dense", src[2], st.out_ch,
                                     1, 1, (1, 1)))

    _walk(cfg, visit)
    return out


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------

BN_MOMENTUM = 0.9


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1) if y.dim() == 4 else y


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class XRNet(nn.Module):
    """DetNet / EDSNet as one module interpreting ``build_plan(cfg)``.

    Submodule ``<step>`` holds that step's parameters (``w``, ``b``,
    ``bn_scale``, ``bn_bias``) and BN buffers (``mean``, ``var``), so the
    state-dict keys are ``<step>.<leaf>``, the JAX tree paths
    ``params[step][leaf]`` (see ``models.params.from_jax``). Weights are
    drawn from ``generator`` (a CPU generator; seed 0 if None) with the
    reference's initializers.
    """

    def __init__(self, cfg: XRConfig, generator: Optional[torch.Generator]
                 = None, *, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.plan = build_plan(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        pdefs, sdefs = param_defs(cfg)
        sd = from_jax(materialize(pdefs, generator, "cpu"),
                      materialize(sdefs, generator, "cpu"))
        for key, t in sd.items():
            step, leaf = key.split(".")
            if not hasattr(self, step):
                self.add_module(step, nn.Module())
            layer = getattr(self, step)
            if leaf in STATE_LEAVES:
                layer.register_buffer(leaf, t)
            else:
                layer.register_parameter(leaf, nn.Parameter(t))
        self.to(dev)

    @torch.no_grad()
    def set_bn_stats(self, images: torch.Tensor) -> None:
        """Set every BN layer's running mean/var to the batch statistics of
        ``images`` (NHWC), as a trained model's EMA holds them on such data.

        With the reference's initial state (mean 0, var 1) an eval forward
        of random weights has a gain of about sqrt(C) per block until relu6
        saturates, so it turns float rounding into O(1) output differences
        (the reference does so itself under a 1e-7 input change); with batch
        statistics it is as well conditioned as the train-mode forward."""
        for st in self.plan:
            if st.op in ("conv", "dwconv") and st.bn:
                getattr(self, st.name).mean.zero_()
                getattr(self, st.name).var.zero_()
        _, new_state = self(images, train=True)
        for name, s in new_state.items():
            layer = getattr(self, name)
            layer.mean.copy_(s["mean"] / (1 - BN_MOMENTUM))
            layer.var.copy_(s["var"] / (1 - BN_MOMENTUM))

    @torch.no_grad()
    def update_bn_state(self, new_state: Dict[str, Dict]) -> None:
        """Write a train-mode forward's ``new_state`` (the EMA of the batch
        statistics) into the BN buffers, detached: the EMA is built from
        graph tensors, and a buffer holding one would keep every step's
        graph alive."""
        for name, s in new_state.items():
            layer = getattr(self, name)
            layer.mean.copy_(s["mean"].detach())
            layer.var.copy_(s["var"].detach())

    def bn_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The BN buffers as the reference's state tree, {step: {mean,
        var}} (the module's own tensors, not copies)."""
        return {st.name: {"mean": getattr(self, st.name).mean,
                          "var": getattr(self, st.name).var}
                for st in self.plan if st.op in ("conv", "dwconv") and st.bn}

    @staticmethod
    def _batchnorm(y, layer, train: bool, momentum: float = BN_MOMENTUM):
        if train:
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)   # jnp.var: population
            new_s = {"mean": momentum * layer.mean + (1 - momentum) * mean,
                     "var": momentum * layer.var + (1 - momentum) * var}
        else:
            mean, var = layer.mean, layer.var
            new_s = {"mean": mean, "var": var}
        inv = torch.rsqrt(var + 1e-5) * layer.bn_scale
        y = (y - _per_channel(mean)) * _per_channel(inv) \
            + _per_channel(layer.bn_bias)
        return y, new_s

    def forward(self, images: torch.Tensor, *, train: bool = False,
                act_scales: Optional[Dict[str, float]] = None,
                act_bits: int = 8, collect_acts: bool = False
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
        """images: (B,H,W,Cin) f32. Returns (outputs dict, new BN state).

        ``train``: BN from batch statistics, and the new state carries their
        EMA (the module's buffers are left as they are). ``act_scales``:
        per-layer symmetric scales -> fake-quantize each conv/dense output,
        saturating at the ``act_bits`` range. ``collect_acts``: also return
        every conv/dense output (NHWC) under outputs["acts"]."""
        x = images.permute(0, 3, 1, 2)        # NHWC data, channels_last NCHW
        scales: Dict[str, torch.Tensor] = {}
        if act_scales:
            from repro_torch.quant import ptq  # models stay importable solo
            act_qmax = ptq.qmax(act_bits)
            # one copy to the device; each scale is a 0-dim view, so y / s
            # is a true division on every device (a Python float divisor on
            # a CUDA tensor becomes a multiply by its reciprocal)
            names = list(act_scales)
            vals = torch.tensor([act_scales[n] for n in names],
                                dtype=images.dtype, device=images.device)
            scales = dict(zip(names, vals))
        tensors: Dict[str, torch.Tensor] = {}
        outputs: Dict[str, torch.Tensor] = {}
        new_state: Dict[str, Dict] = {}
        collected: Dict[str, torch.Tensor] = {}

        def _aq(name, y):
            if collect_acts:
                collected[name] = _nhwc(y)
            if name in scales:
                s = scales[name]
                y = torch.clamp(torch.round(y / s), -act_qmax, act_qmax) * s
            return y

        for st in self.plan:
            src = x if st.src == "_" else tensors[st.src]
            if st.op in ("conv", "dwconv"):
                layer = getattr(self, st.name)
                if uses_depthwise_kernel(st):
                    xin = src.contiguous(memory_format=torch.channels_last)
                    y = ops.depthwise_conv3x3(xin.permute(0, 2, 3, 1),
                                              layer.w).permute(0, 3, 1, 2)
                else:
                    groups = src.shape[1] if st.op == "dwconv" else 1
                    y = F.conv2d(src, layer.w, stride=st.stride,
                                 padding=(st.kernel - 1) // 2, groups=groups)
                if st.bn:
                    y, new_state[st.name] = self._batchnorm(y, layer, train)
                if st.relu:
                    y = torch.clamp(y, 0.0, 6.0)          # relu6
                y = _aq(st.name, y)
            elif st.op == "dense":
                layer = getattr(self, st.name)
                v = src.reshape(src.shape[0], -1)
                y = torch.matmul(v, layer.w.t()) + layer.b
                if st.relu:
                    y = torch.relu(y)
                y = _aq(st.name, y)
            elif st.op == "gpool":
                y = src.mean(dim=(2, 3), keepdim=True)
            elif st.op == "upsample":
                y = F.interpolate(src, scale_factor=2, mode="nearest")
            elif st.op == "concat":
                y = torch.cat([src, tensors[st.skip]], dim=1)
            elif st.op == "add":
                y = src + tensors[st.skip]
            else:
                raise ValueError(st.op)
            x = y
            if st.save_as:
                tensors[st.save_as] = y
                if st.save_as.startswith("out_"):
                    outputs[st.save_as[4:]] = _nhwc(y)
        if collect_acts:
            outputs["acts"] = collected
        return outputs, new_state


# ---------------------------------------------------------------------------
# losses (paper section 2.2), on the NHWC outputs
# ---------------------------------------------------------------------------

def circle_loss(outputs: Dict, batch: Dict, center_weight: float = 10.0
                ) -> Tuple[torch.Tensor, Dict]:
    """DetNet: weighted MSE on circle center+radius, CE on hand label."""
    center = outputs["center"].reshape(-1, 2, 2)
    radius = outputs["radius"]
    mse_c = torch.mean((center - batch["center"]) ** 2)
    mse_r = torch.mean((radius - batch["radius"]) ** 2)
    circle = center_weight * mse_c + mse_r
    logits = outputs["label"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["label"].long()[:, None])[:, 0]
    ce = torch.mean(logz - gold)
    return circle + ce, {"circle": circle, "label_ce": ce,
                         "center_mse": mse_c, "radius_mse": mse_r}


def dice_loss(outputs: Dict, batch: Dict, eps: float = 1.0
              ) -> Tuple[torch.Tensor, Dict]:
    """EDSNet: soft multi-class Dice over (B,H,W,C) logits vs int masks."""
    logits = outputs["mask"]
    C = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(batch["mask"].long(), C).to(torch.float32)
    inter = torch.sum(probs * onehot, dim=(0, 1, 2))
    union = torch.sum(probs + onehot, dim=(0, 1, 2))
    dice = (2 * inter + eps) / (union + eps)
    loss = 1.0 - torch.mean(dice)
    return loss, {"dice": 1.0 - loss}


def iou(outputs: Dict, batch: Dict) -> torch.Tensor:
    """Mean IoU over the classes for eval (a class absent from both the
    prediction and the mask counts 1)."""
    pred = torch.argmax(outputs["mask"], dim=-1)
    C = outputs["mask"].shape[-1]
    ious = []
    for c in range(C):
        p, g = pred == c, batch["mask"] == c
        inter = torch.sum(p & g).to(torch.float32)
        union = torch.sum(p | g).to(torch.float32)
        ious.append(torch.where(union > 0, inter / union.clamp_min(1),
                                torch.ones_like(union)))
    return torch.mean(torch.stack(ious))
