#!/usr/bin/env python3
"""Peak device memory of one LM training step on the card, per batch size.

    PYTHONPATH=src python tools/lm_train_memory.py [--arch mamba2-1.3b]
        [--batch 1 2] [--seq 2048] [--repeats N] [--expandable-segments]

Runs one step of ``repro_torch.launch.train.train`` (full-width config,
full depth or its first N repeats of the layer pattern, bf16, random
weights) for each batch size, in a fresh process each so that one size's
allocations cannot crowd the next, and prints the peak of
``torch.cuda.max_memory_allocated`` or "out of memory" with the card's
name and power limit. ``--expandable-segments`` runs the steps with the
allocator setting ``chip_smoke.py``'s slice-9 phase uses. It decides the
batch size and sequence length ``chip_smoke.py`` trains each LM at.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(arch: str, batch: int, seq: int, repeats: int) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    cfg = get_config(arch)
    if repeats:
        cfg = dataclasses.replace(
            cfg, num_layers=repeats * lm.block_period(cfg))
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train.train(cfg, steps=1, batch=batch, seq=seq, log_every=0)
        out = {"loss": res.losses[0]}
    except torch.OutOfMemoryError:
        out = {"loss": None, "out_of_memory": True}
    torch.cuda.synchronize()
    return dict(out, arch=arch, batch=batch, seq=seq, layers=cfg.num_layers,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                card_gib=torch.cuda.get_device_properties(0).total_memory
                / 2 ** 30)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", nargs="+", default=["llama3.2-1b",
                                                 "mamba2-1.3b"])
    p.add_argument("--batch", nargs="+", type=int, default=[1, 2])
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--repeats", type=int, default=0,
                   help="repeats of the layer pattern (0: full depth)")
    p.add_argument("--expandable-segments", action="store_true")
    p.add_argument("--one", nargs=4, help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.one:
        print(json.dumps(one(a.one[0], *map(int, a.one[1:]))))
        return
    env = dict(os.environ)
    if a.expandable_segments:
        env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    for arch in a.arch:
        for b in a.batch:
            r = subprocess.run([sys.executable, __file__, "--one", arch,
                                str(b), str(a.seq), str(a.repeats)],
                               capture_output=True, text=True, check=True,
                               env=env)
            row = json.loads(r.stdout.strip().splitlines()[-1])
            state = ("out of memory" if row.get("out_of_memory")
                     else f"loss {row['loss']:.4f}")
            print(f"{arch} {row['layers']} layers B={b} S={a.seq}: peak "
                  f"{row['peak_gib']:.2f} GiB of {row['card_gib']:.2f}, "
                  f"{state}")


if __name__ == "__main__":
    main()
