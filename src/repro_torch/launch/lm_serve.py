"""Serve a small LM through the continuous-batching engine, fp32 against
INT8-PTQ weights side by side: the port of ``examples/lm_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_serve \
        [--arch llama3.2-1b] [--device cuda]

The example's requests (a batch of 4, ``max_seq`` 64, 8 prompts of 6 tokens
drawn from numpy seed 0, 8 new tokens each) go through the same server
twice on the smoke config's random weights (torch seed 0): once with the
weights as they are, once fake-quantized to INT8 per output column. It
prints each run's tokens per second and the greedy agreement (requests
whose tokens are the same in both). ``--device cpu`` runs the plain
PyTorch path on a host without a card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import LM_ARCHS, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine

BATCH, MAX_SEQ, REQUESTS, PROMPT, NEW = 4, 64, 8, 6, 8


def run(cfg: ModelConfig, params: Dict, quantize: bool,
        device: DeviceLike = "cuda") -> Tuple[List[Request], float]:
    """The example's requests through one ``ServeEngine``; returns the
    finished requests and tokens per second from the first submit to the
    last token."""
    eng = ServeEngine(cfg, params, batch_size=BATCH, max_seq=MAX_SEQ,
                      quantize=quantize, device=device)
    rng = np.random.default_rng(0)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.monotonic()
    for uid in range(REQUESTS):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(1, cfg.vocab_size, PROMPT).astype(np.int32),
            max_new_tokens=NEW))
    done = eng.run()
    dt = time.monotonic() - t0
    return done, sum(len(r.out_tokens) for r in done) / dt


def agreement(fp_done: Sequence[Request], q_done: Sequence[Request]) -> int:
    """Requests whose greedy tokens are the same in both runs."""
    return sum(f.out_tokens == q.out_tokens for f, q in zip(
        sorted(fp_done, key=lambda r: r.uid),
        sorted(q_done, key=lambda r: r.uid)))


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[List[Request], List[Request]]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b", choices=LM_ARCHS)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cfg = get_smoke(a.arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            resolve_device(a.device))

    fp_done, fp_rate = run(cfg, params, quantize=False, device=a.device)
    q_done, q_rate = run(cfg, params, quantize=True, device=a.device)
    print(f"{a.arch}: fp32 {fp_rate:.1f} tok/s | int8 {q_rate:.1f} tok/s | "
          f"greedy agreement {agreement(fp_done, q_done)}/{len(fp_done)} "
          f"requests (device={a.device})")
    for r in sorted(fp_done, key=lambda r: r.uid)[:3]:
        print(f"  req {r.uid}: {r.prompt.tolist()} -> {r.out_tokens}")
    return fp_done, q_done


if __name__ == "__main__":
    main()
