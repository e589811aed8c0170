"""The paper's pipeline in four steps, the port of ``examples/quickstart.py``:
train DetNet on synthetic FPHAB-style frames, quantize it to INT8, extract
its layer specs, then ask the pricing plane whether the modelled XR
accelerator's memory should be SRAM or MRAM at a 10-inferences/second
hand-tracking duty cycle.

    PYTHONPATH=src python -m repro_torch.launch.quickstart \
        [--full] [--steps 30] [--device cuda]

Steps 1-2 run on the card (``--device cpu``: the plain PyTorch path on a
host without one); ``--full`` trains the paper's full-width 128x128 DetNet,
else its smoke config. Steps 3-4 run in numpy on the host. Every priced
figure (memory power, savings, latency) is the model's estimate for a Simba
accelerator at 7 nm, not a measurement of the machine this runs on.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import dse, nvm
from repro_torch.data import synthetic
from repro_torch.models import xr
from repro_torch.quant import ptq
from repro_torch.train import loop

IPS = 10.0                       # the hand-tracking duty cycle
ARCH, NODE = "simba", 7          # the modelled accelerator
VARIANTS = ("sram", "p0", "p1")


def price(specs) -> Dict[str, Dict[str, float]]:
    """SRAM, P0 and P1 reports of ``specs`` on Simba at 7 nm: memory power
    at ``IPS`` (W), savings against SRAM there, latency (ms)."""
    reps = {v: dse.evaluate(specs, ARCH, NODE, v) for v in VARIANTS}
    return {v: {"memory_power_w": nvm.memory_power_w(r, IPS),
                "savings": nvm.savings_at_ips(r, reps["sram"], IPS),
                "latency_ms": r.latency_s * 1e3}
            for v, r in reps.items()}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. train
    cfg = get_config("detnet") if a.full else get_smoke("detnet")
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device=a.device)
    dev = next(net.parameters()).device
    res = loop.run_xr_training(
        net, synthetic.fphab_batches(8, cfg.input_hw, cfg.in_channels),
        loss_fn=xr.circle_loss, steps=a.steps, lr=3e-3,
        hooks=loop.TrainHooks(log_every=10))

    # 2. quantize (TensorRT-style INT8 PTQ) and run one frame
    qparams = ptq.quantize_params(dict(net.named_parameters()))
    img = torch.from_numpy(
        synthetic.fphab_sample(0, 0, cfg.input_hw)["image"])[None].to(dev)
    outs, _ = ptq.forward_int8(net, img)
    n = sum(t.numel() for t in qparams.values())
    print(f"\ntrained {n:,} params on {dev}, final loss {res.losses[-1]:.3f}"
          f", quantized to INT8; INT8 center of one frame "
          f"{outs['center'][0][:2].cpu().numpy()}")

    # 3. the layer specs of the trained config
    specs = xr.conv_layer_specs(net.cfg)
    print(f"{len(specs)} layer specs, {sum(s.macs for s in specs):,} MACs "
          "an inference")

    # 4. price them: the modelled accelerator, not this machine
    priced = price(specs)
    print(f"\nmodelled {ARCH.capitalize()} accelerator at {NODE} nm, "
          f"{IPS:.0f} inferences/s (hand-tracking duty cycle):")
    for v, r in priced.items():
        vs = "" if v == "sram" else f" ({r['savings']:+.0%} vs SRAM)"
        print(f"  {v.upper():4s}: {r['memory_power_w'] * 1e6:8.1f} uW memory "
              f"power{vs}, latency {r['latency_ms']:.2f} ms")
    return {"result": res, "outputs": outs, "specs": specs, "priced": priced}


if __name__ == "__main__":
    main()
