"""Serving entry point: the continuous-batching engine over a smoke model, port
of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        [--requests 8] [--batch 4] [--max-seq 128] [--int8] [--device cuda]

``--device cpu`` runs the plain PyTorch path on a host without a card.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import LM_ARCHS, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def make_requests(cfg: ModelConfig, n: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` requests with prompts of 4-11 random tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(4, 12))
        reqs.append(Request(uid=uid,
                            prompt=rng.integers(1, cfg.vocab_size,
                                                plen).astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


def serve(cfg: ModelConfig, params: Dict, requests: Sequence[Request], *,
          batch: int = 4, max_seq: int = 128, int8: bool = False,
          device: DeviceLike = "cuda") -> Tuple[List[Request], float]:
    """Run ``requests`` through a ``ServeEngine``; returns the finished
    requests and the seconds from the first submit to the last token."""
    eng = ServeEngine(cfg, params, batch_size=batch, max_seq=max_seq,
                      quantize=int8, device=device)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.monotonic()
    for r in requests:
        eng.submit(r)
    done = eng.run()
    return done, time.monotonic() - t0


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b", choices=LM_ARCHS)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    cfg = get_smoke(a.arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), a.device)
    done, dt = serve(cfg, params, make_requests(cfg, a.requests, a.max_new),
                     batch=a.batch, max_seq=a.max_seq, int8=a.int8,
                     device=a.device)
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s, int8={a.int8}, device={a.device})")
    for r in sorted(done, key=lambda r: r.uid)[:4]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
