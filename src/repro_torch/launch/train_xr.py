"""Training entry point for the paper's XR nets, port of
``examples/train_detnet.py`` and ``examples/train_edsnet.py``: train DetNet
(circle loss on synthetic FPHAB-style frames) or EDSNet (Dice loss on
synthetic OpenEDS-style eye images), then compare FP32 with INT8 PTQ on a
held-out frame.

    PYTHONPATH=src python -m repro_torch.launch.train_xr --arch detnet \
        [--full] [--steps 300] [--batch 8] [--lr 3e-3] [--ckpt-dir DIR] \
        [--device cuda]

``--full`` trains the paper's full-size net (128x128 DetNet, 384x640
EDSNet), else its smoke config. ``--device cpu`` runs the plain PyTorch
path on a host without a card; by default it runs on the card and raises
on a host without one.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import XR_ARCHS, get_config, get_smoke
from repro_torch.data import synthetic
from repro_torch.models import xr
from repro_torch.quant import ptq
from repro_torch.train import loop

# per arch: (loss, default steps, default batch, log every), as the examples
DEFAULTS = {"detnet": (xr.circle_loss, 300, 8, 20),
            "edsnet": (xr.dice_loss, 60, 4, 15)}


def batches(cfg, batch: int):
    """The arch's synthetic loader: (batch, loader index) pairs; EDSNet's
    batches carry the image and the mask only, as the example's."""
    if cfg.task == "detection":
        yield from synthetic.fphab_batches(batch, cfg.input_hw,
                                           cfg.in_channels)
        return
    for b, idx in synthetic.openeds_batches(batch, cfg.input_hw):
        yield {"image": b["image"], "mask": b["mask"]}, idx


def evaluate(net, dev: torch.device) -> Dict:
    """FP32 against INT8 PTQ (weights only, as the examples) on a held-out
    frame: DetNet's first predicted center, EDSNet's mean IoU."""
    cfg = net.cfg
    if cfg.task == "detection":
        sample = synthetic.fphab_sample(1, 999, cfg.input_hw)
    else:
        sample = synthetic.openeds_sample(7, 12345, cfg.input_hw)
    img = torch.from_numpy(sample["image"])[None].to(dev)
    with torch.no_grad():
        fp, _ = net(img)
    q, _ = ptq.forward_int8(net, img)
    if cfg.task == "detection":
        return {"center": sample["center"][0],
                "fp32": fp["center"][0][:2].cpu().numpy(),
                "int8": q["center"][0][:2].cpu().numpy()}
    gt = {"mask": torch.from_numpy(sample["mask"])[None].to(dev)}
    return {"fp32": float(xr.iou(fp, gt)), "int8": float(xr.iou(q, gt))}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="detnet", choices=XR_ARCHS)
    p.add_argument("--full", action="store_true")
    p.add_argument("--steps", type=int)
    p.add_argument("--batch", type=int)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--ckpt-dir")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    # the nets train in full f32, as the CPU tests hold them to the
    # reference (cuDNN's default for f32 convolutions is TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    loss_fn, steps, batch, log_every = DEFAULTS[a.arch]
    steps = a.steps if a.steps is not None else steps
    batch = a.batch if a.batch is not None else batch
    cfg = get_config(a.arch) if a.full else get_smoke(a.arch)
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device=a.device)
    dev = next(net.parameters()).device
    n = sum(t.numel() for t in net.parameters())
    print(f"{a.arch} ({'full' if a.full else 'smoke'}): {n:,} params, input "
          f"{cfg.input_hw}, batch {batch}, device {dev}")

    res = loop.run_xr_training(
        net, batches(cfg, batch), loss_fn=loss_fn, steps=steps, lr=a.lr,
        ckpt_dir=a.ckpt_dir, ckpt_every=50,
        hooks=loop.TrainHooks(log_every=log_every))
    if res.losses:
        print(f"\nloss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} over "
              f"{len(res.losses)} steps")

    ev = evaluate(net, dev)
    if cfg.task == "detection":
        print("\nheld-out frame (normalized coords):")
        print(f"  ground truth center: {ev['center']}")
        print(f"  FP32 prediction    : {np.asarray(ev['fp32'])}")
        print(f"  INT8 prediction    : {np.asarray(ev['int8'])}")
    else:
        print(f"held-out mIoU: FP32 {ev['fp32']:.3f}  INT8 {ev['int8']:.3f}")
    return {"result": res, "eval": ev}


if __name__ == "__main__":
    main()
