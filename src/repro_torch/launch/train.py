"""Training entry point for the LM architectures, port of
``repro.launch.train`` on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] \
        [--ckpt-dir DIR] [--ckpt-every N] [--compress-grads] [--device cuda]

The same flags as the reference, the same cosine schedule (warmup
``max(1, steps // 10)``), the same checkpoint tree ``{"p": params, "o":
opt_state}`` with the loader index, and the same resume: from the latest
checkpoint, the token stream restarted at ``start * batch``. Parameters are
random from seed 0 (a torch generator: the reference's law, other numbers).
There is no ``--mesh``: the reference builds a mesh from the live devices
and shards the parameters by their logical axes; the port runs on one
device until the sharding slice (ROADMAP.md, Queue 1). ``--device
cpu`` runs the plain PyTorch path on a host without a card; by default it
runs on the card and raises on a host without one. On the card the
attention and the SSD scan run forward and backward on the hand-written
kernels.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import LM_ARCHS, get_config, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm
from repro_torch.models import params as params_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import loop, optim


@dataclass
class LMTrainResult:
    params: Dict                          # the parameter tree, trained
    opt_state: optim.AdamWState           # keyed like params_mod.flatten
    losses: List[float]                   # one per step this call ran
    step_s: List[float] = field(default_factory=list)   # host seconds
    start: int = 0                        # the step it resumed from
    step: int = 0                         # the step it reached


def train_tree(params: Dict, opt_state: optim.AdamWState) -> Dict:
    """What a checkpoint holds, in the reference's keys: {"p": the
    parameter tree, "o": the AdamW state with m and v as trees}."""
    return {"p": params,
            "o": {"m": params_mod.unflatten(opt_state.m),
                  "v": params_mod.unflatten(opt_state.v),
                  "count": opt_state.count}}


def _load(params: Dict, tree: Dict, dev: torch.device) -> optim.AdamWState:
    """Write a restored ``train_tree`` into ``params`` (in place); returns
    the optimizer state on ``dev``."""
    restored = params_mod.flatten(tree["p"])
    with torch.no_grad():
        for k, p in params_mod.flatten(params).items():
            p.copy_(restored[k])
    o = tree["o"]
    return optim.AdamWState(
        {k: t.to(dev) for k, t in params_mod.flatten(o["m"]).items()},
        {k: t.to(dev) for k, t in params_mod.flatten(o["v"]).items()},
        o["count"].to(dev))


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, compress_grads: bool = False,
          device: DeviceLike = "cuda", seed: int = 0, log_every: int = 10,
          heartbeat: Optional[Callable[[int, float], None]] = None
          ) -> LMTrainResult:
    """Train ``cfg`` to ``steps`` steps on synthetic token batches of
    ``batch`` x ``seq``, from random parameters drawn from ``seed`` or the
    latest checkpoint under ``ckpt_dir``; checkpoint every ``ckpt_every``
    steps. The batches hold tokens only, as the reference launcher's do: a
    VLM (phi-3-vision) trains text-only, and an encoder-decoder (whisper)
    raises ``models.lm.forward``'s ``ValueError`` at its first step, its
    batch needing encoder frames (train it through ``lm_loss`` and
    ``make_lm_step`` with a batch that holds them). ``heartbeat(step, seconds)`` is called after every step. A run
    whose latest checkpoint is already at ``steps`` returns at once, with no
    steps and no losses."""
    dev = resolve_device(device)
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    lr_fn = optim.cosine_schedule(lr, warmup=max(1, steps // 10), total=steps)
    step_fn = loop.make_lm_step(cfg, params, lr_fn,
                                compress_grads=compress_grads)
    opt_state = optim.adamw_init(params_mod.flatten(params))

    start = 0
    if ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        tree, start, _ = ckpt_mod.restore(ckpt_dir,
                                          train_tree(params, opt_state))
        opt_state = _load(params, tree, dev)
        print(f"resumed from step {start}")

    batches = synthetic.token_batches(batch, seq, cfg.vocab_size,
                                      start_idx=start * batch)
    losses, times = [], []
    for step in range(start, steps):
        t0 = time.monotonic()
        b, loader_idx = next(batches)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        opt_state, metrics = step_fn(opt_state, b, step)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.monotonic() - t0
        times.append(dt)
        if heartbeat:
            heartbeat(step, dt)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:4d} loss {loss:.4f} ({dt:.2f}s/step)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt_dir, step + 1, train_tree(params, opt_state),
                          extra={"loader_idx": loader_idx})
    return LMTrainResult(params, opt_state, losses, times, start,
                         start + len(losses))


def main(argv: Optional[Sequence[str]] = None) -> LMTrainResult:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=LM_ARCHS)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    # f32 convolutions (Mamba's causal conv) in full f32, not cuDNN's TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(a.arch) if a.smoke else get_config(a.arch)
    print(f"arch={cfg.name} device={a.device} params={cfg.param_count():,}")
    res = train(cfg, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr,
                ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                compress_grads=a.compress_grads, device=a.device)
    print("done")
    return res


if __name__ == "__main__":
    main()
