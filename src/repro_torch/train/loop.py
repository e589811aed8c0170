"""The training steps and the XR training loop, port of
``repro.train.loop``: ``make_xr_step`` and ``run_xr_training`` (the paper's
DetNet/EDSNet workloads) and ``make_lm_step`` (the LM loop is
``launch.train``'s, as in the reference).

The net (``models.xr.XRNet``) holds the parameters and the BN state; a step
runs the train-mode forward, ``loss.backward()``, global-norm clipping and
the reference's AdamW, then writes the updated parameters and the BN EMA
back into the net. On the card every stride-1 depthwise step runs the
hand-written kernel forward and backward. The outer loop owns
checkpointing (atomic and async, in the reference's keys and layouts),
resume from the latest checkpoint with the loader skipped to its place, a
SIGTERM preemption hook and a per-step heartbeat with a straggler log.
"""
from __future__ import annotations

import contextlib
import itertools
import signal
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import torch

from repro_torch.models import lm
from repro_torch.models import params as params_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import compress as compress_mod
from repro_torch.train import optim


@dataclass
class TrainHooks:
    """Operational hooks for large-scale runs."""
    heartbeat: Optional[Callable[[int, float], None]] = None  # (step, dt)
    on_preempt: Optional[Callable[[int], None]] = None
    straggler_threshold: float = 3.0     # x median step time -> log warning
    log_every: int = 10


@dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]      # the net's parameters, by name
    opt_state: optim.AdamWState
    extras: Dict                         # {"state": the BN state tree}
    losses: list
    step: int


def make_xr_step(net, loss_fn, lr_fn, max_grad_norm: float = 1.0):
    """DetNet/EDSNet step: (opt_state, batch, step) -> (opt_state,
    metrics), updating ``net``'s parameters and BN buffers in place.
    Raises if a parameter got no gradient: a kernel that returned a result
    detached from the graph would otherwise train the rest silently."""
    params = dict(net.named_parameters())

    def step_fn(opt_state, batch, step):
        for p in params.values():
            p.grad = None
        outs, new_state = net(batch["image"], train=True)
        loss, metrics = loss_fn(outs, batch)
        loss.backward()
        missing = [k for k, p in params.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        grads = {k: p.grad for k, p in params.items()}
        with torch.no_grad():
            grads, gnorm = optim.clip_by_global_norm(grads, max_grad_norm)
            new_p, opt_state = optim.adamw_update(
                grads, opt_state, params, lr=float(lr_fn(step)))
            for k, p in params.items():
                p.copy_(new_p[k])
        net.update_bn_state(new_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    return step_fn


def make_lm_step(cfg, params: Dict, lr_fn, max_grad_norm: float = 1.0,
                 compress_grads: bool = False):
    """LM step: (opt_state, batch, step) -> (opt_state, metrics), the twin
    of the reference's ``make_lm_step``: ``lm.lm_loss``, ``backward()``,
    global-norm clipping and AdamW, the parameter tree ``params`` (its
    leaves made to require grad) updated in place. The optimizer state is
    keyed like ``models.params.flatten(params)``. With ``compress_grads``
    the gradients pass through INT8 compression with error feedback first
    (``train.compress``, as the reference's launcher does; the error is
    held in ``step_fn.error``). Raises if a parameter got no gradient."""
    flat = params_mod.flatten(params)
    for p in flat.values():
        p.requires_grad_(True)

    def step_fn(opt_state, batch, step):
        for p in flat.values():
            p.grad = None
        loss, metrics = lm.lm_loss(cfg, params, batch)
        loss.backward()
        missing = [k for k, p in flat.items() if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        grads = {k: p.grad for k, p in flat.items()}
        with torch.no_grad():
            if compress_grads:
                q, scales, step_fn.error = compress_mod.compress(
                    grads, step_fn.error)
                grads = compress_mod.decompress(q, scales)
            grads, gnorm = optim.clip_by_global_norm(grads, max_grad_norm)
            new_p, opt_state = optim.adamw_update(
                grads, opt_state, flat, lr=float(lr_fn(step)))
            for k, p in flat.items():
                p.copy_(new_p[k])
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    step_fn.error = compress_mod.init_error(flat) if compress_grads else None
    return step_fn


def _train_tree(net, opt_state) -> Dict:
    """What a checkpoint holds, in the reference's keys and layouts."""
    return params_mod.xr_train_to_jax(net.state_dict(), opt_state.m,
                                      opt_state.v, opt_state.count)


def _load(net, opt_state, tree) -> optim.AdamWState:
    """Write a restored training tree into ``net``; returns the optimizer
    state on the net's device."""
    sd, m, v, count = params_mod.xr_train_from_jax(tree)
    net.load_state_dict(sd)
    dev = opt_state.count.device
    return optim.AdamWState({k: t.to(dev) for k, t in m.items()},
                            {k: t.to(dev) for k, t in v.items()},
                            count.to(dev))


def run_xr_training(net, batches: Iterator, *, loss_fn, steps: int,
                    lr: float = 1e-3, ckpt_dir: Optional[str] = None,
                    ckpt_every: int = 100,
                    hooks: Optional[TrainHooks] = None,
                    resume: bool = True) -> TrainResult:
    """Train ``net`` (an ``XRNet``, on its device) to ``steps`` steps.

    ``batches`` yields (batch of numpy arrays, loader index after it), as
    ``data.synthetic``'s loaders do. With ``ckpt_dir`` a checkpoint is
    written every ``ckpt_every`` steps (on a writer thread) and on SIGTERM
    (synchronously, then the loop stops); with ``resume`` the run starts
    from the latest checkpoint there, its loader fast-forwarded past the
    batches the checkpointed steps took."""
    hooks = hooks if hooks is not None else TrainHooks()
    dev = next(net.parameters()).device
    lr_fn = optim.cosine_schedule(lr, warmup=min(50, steps // 10 + 1),
                                  total=steps)
    step_fn = make_xr_step(net, loss_fn, lr_fn)
    opt_state = optim.adamw_init(dict(net.named_parameters()))
    start = 0

    if ckpt_dir and resume and ckpt_mod.latest_step(ckpt_dir) is not None:
        tree, start, extra = ckpt_mod.restore(ckpt_dir,
                                              _train_tree(net, opt_state))
        opt_state = _load(net, opt_state, tree)
        batches = _skip_to(batches, extra.get("loader_idx", 0))

    preempted, installed = [], []
    with contextlib.suppress(ValueError):      # non-main thread
        installed.append(signal.signal(signal.SIGTERM,
                                       lambda *_: preempted.append(True)))

    losses, times, writer, done = [], [], None, start
    try:
        for step in range(start, steps):
            t0 = time.monotonic()
            batch, loader_idx = next(batches)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            opt_state, metrics = step_fn(opt_state, batch, step)
            loss = float(metrics["loss"])
            losses.append(loss)
            done = step + 1
            dt = time.monotonic() - t0
            times.append(dt)
            if hooks.heartbeat:
                hooks.heartbeat(step, dt)
            med = sorted(times)[len(times) // 2]
            if dt > hooks.straggler_threshold * med and len(times) > 10:
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
            if hooks.log_every and step % hooks.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()
                    if k != "loss"))
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                if writer is not None:
                    writer.join()
                writer = ckpt_mod.save_async(
                    ckpt_dir, step + 1, _train_tree(net, opt_state),
                    extra={"loader_idx": loader_idx})
            if preempted:
                if hooks.on_preempt:
                    hooks.on_preempt(step)
                if ckpt_dir:
                    if writer is not None:
                        writer.join()
                    ckpt_mod.save(ckpt_dir, step + 1,
                                  _train_tree(net, opt_state),
                                  extra={"loader_idx": loader_idx})
                break
    finally:
        if writer is not None:
            writer.join()
        for previous in installed:             # the caller's handler back
            signal.signal(signal.SIGTERM, previous
                          if previous is not None else signal.SIG_DFL)
    params = {k: p.detach() for k, p in net.named_parameters()}
    return TrainResult(params, opt_state, {"state": net.bn_state()}, losses,
                       done)


def _skip_to(batches: Iterator, loader_idx: int) -> Iterator:
    """Loader state restore: drop the batches that end at or before
    ``loader_idx`` (the index the loader had reached when the checkpoint
    was written). A loader already started there (``start_idx``) loses
    nothing."""
    batches = iter(batches)
    for batch, idx in batches:
        if idx > loader_idx:
            return itertools.chain([(batch, idx)], batches)
    return batches
