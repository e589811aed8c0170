"""Where Whisper's f32 gradients on the card part from f64.

One smoke-config Whisper step in f32 with encoder frames (the step of
``tests/test_torch_cuda.py::test_encdec_vlm_step_on_the_card_matches_the_cpu``),
for several seeds, five ways: on the card through the kernels, on the card
through the plain versions (every ``ops`` call routed to ``kernels.ref``, so
attention is ATen/cuBLAS), on the card in f64 (plain), on the CPU in f32 and
in f64. Each f32 gradient is measured against the card's f64 gradient, leaf
by leaf, in units of the largest f64 entry; the two f64 evaluations are held
to each other. Prints one line a seed and writes
``build/encdec_grad_f64.json``.

    PYTHONPATH=src python tools/encdec_grad_f64.py [--seeds 5 6 7 8 9 10 11 12]
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402

LEAF = "blocks.blk0.xattn.norm"      # the cross-attention norm (stacked)


def grads(cfg, seed, dev, dtype, plain):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (2, 65)).astype(np.int32)
    frames = rng.normal(size=(2, cfg.num_encoder_frames, cfg.d_model)
                        ).astype(np.float32)
    c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    flat = flatten(params)
    for p in flat.values():
        p.data = p.data.to(dtype)
        p.requires_grad_(True)
    x = torch.from_numpy(frames).to(dev, dtype).requires_grad_(True)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
             "labels": torch.from_numpy(tok[:, 1:]).to(dev),
             "encoder_frames": x}
    on_cuda = ops._on_cuda
    if plain:
        ops._on_cuda = lambda t: False
    try:
        before = dict(ops.launches())
        lm.lm_loss(c, params, batch)[0].backward()
        launched = {k: v - before[k] for k, v in ops.launches().items()
                    if v != before[k]}
    finally:
        ops._on_cuda = on_cuda
    return ({**{k: p.grad.double().cpu() for k, p in flat.items()},
             "encoder_frames": x.grad.double().cpu()}, launched)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[5, 6, 7, 8, 9, 10, 11, 12])
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = dataclasses.replace(get_smoke("whisper-small"), dtype="float32")
    ways = {"card kernels f32": (cuda, torch.float32, False),
            "card plain f32": (cuda, torch.float32, True),
            "cpu f32": (cpu, torch.float32, False),
            "cpu f64": (cpu, torch.float64, False)}
    out = {"card": torch.cuda.get_device_name(0), "leaf": LEAF, "seeds": {}}
    print(f"card: {out['card']}; distances from the card's f64 gradient, "
          f"in units of its largest entry; leaf {LEAF} and the worst leaf")
    for seed in a.seeds:
        g64, _ = grads(cfg, seed, cuda, torch.float64, True)
        gmax = max(float(t.abs().max()) for t in g64.values())
        row = {}
        for name, (dev, dt, plain) in ways.items():
            g, launched = grads(cfg, seed, dev, dt, plain)
            off = {k: float((g[k] - g64[k]).abs().max()) / gmax for k in g64}
            worst = max(off, key=off.get)
            row[name] = {"leaf": off[LEAF], "worst_leaf": worst,
                         "worst": off[worst], "launches": launched}
        ratio = row["card kernels f32"]["leaf"] / row["cpu f32"]["leaf"]
        row["card_over_cpu"] = ratio
        row["plain_over_cpu"] = (row["card plain f32"]["leaf"]
                                 / row["cpu f32"]["leaf"])
        out["seeds"][seed] = row
        print(f"seed {seed}: " + "; ".join(
            f"{n} {r['leaf']:.3e} (worst {r['worst_leaf']} {r['worst']:.3e})"
            for n, r in row.items() if isinstance(r, dict))
            + f"; card/cpu {ratio:.3f}, card plain/cpu "
            f"{row['plain_over_cpu']:.3f}")
    ratios = [r["card_over_cpu"] for r in out["seeds"].values()]
    plain = [r["plain_over_cpu"] for r in out["seeds"].values()]
    out["card_over_cpu"] = {"min": min(ratios), "median": float(
        np.median(ratios)), "max": max(ratios)}
    out["plain_over_cpu"] = {"min": min(plain), "median": float(
        np.median(plain)), "max": max(plain)}
    print(f"card kernels / cpu at {LEAF}: {out['card_over_cpu']}; card plain"
          f" / cpu: {out['plain_over_cpu']}; f64 card vs cpu: "
          f"{max(r['cpu f64']['worst'] for r in out['seeds'].values()):.3e}")
    os.makedirs(ROOT / "build", exist_ok=True)
    (ROOT / "build" / "encdec_grad_f64.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
