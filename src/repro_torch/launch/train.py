"""Training entry point for the LM architectures, port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--smoke] [--steps N] [--batch B] [--seq S] [--lr LR] \
        [--ckpt-dir DIR] [--ckpt-every N] [--compress-grads] [--device cuda]
    PYTHONPATH=src torchrun --nproc-per-node=N -m repro_torch.launch.train \
        --arch llama3.2-1b --mesh auto|production|multipod [...]

The same flags as the reference, the same cosine schedule (warmup
``max(1, steps // 10)``), the same checkpoint tree ``{"p": params, "o":
opt_state}`` with the loader index, and the same resume: from the latest
checkpoint, the token stream restarted at ``start * batch``. Parameters are
random from seed 0 (a torch generator: the reference's law, other numbers).
``--device cpu`` runs the plain PyTorch path on a host without a card; by
default it runs on the card and raises on a host without one. On the card
the attention and the SSD scan run forward and backward on the
hand-written kernels.

``--mesh`` shards the run over the ranks of a ``torchrun`` launch, as the
reference's ``--mesh`` does over its devices: ``auto`` is a ("data",
"model") mesh of gcd(min(4, ranks), ranks) model ranks, ``production``
and ``multipod`` the (16, 16) and (2, 16, 16) meshes. The process group
comes from torchrun's environment: NCCL on the card (one card a rank),
gloo with ``--device cpu``. Parameters are drawn whole from the same seed
on every rank and then split by their logical axes (``sharding``, with the
reference's divisibility rule), so a sharded run starts from the
unsharded run's parameters; the optimizer state, the gradients and the
checkpoint tree are split alike, and the kernels run per shard. A launch
of more than one rank without ``--mesh`` takes ``auto``, as the
reference's default. A caller of ``train`` that passes no mesh, and a
one-rank CLI run outside torchrun without ``--mesh``, run the one-device
path unchanged. Nothing switches device or backend on its own: a mesh that
cannot be built (no torchrun environment, a world size the production
mesh does not have) raises.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import LM_ARCHS, get_config, get_smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.device import DeviceLike, resolve_device
from repro_torch import sharding
from repro_torch.launch import mesh as mesh_mod
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


def shard_params(cfg: ModelConfig, params: Dict, mesh) -> Dict:
    """``params`` (whole, the same on every rank) split over ``mesh`` by
    their logical axes, the reference's divisibility rule applied."""
    defs = lm.param_defs(cfg)
    specs = sharding.fix_divisibility(
        sharding.spec_tree(params_mod.logical_axes(defs), mesh), defs, mesh)
    return sharding.tree_map(lambda t, sp: sharding.distribute(t, sp, mesh),
                             params, specs)


def shardings_of(tree):
    """(mesh, placements) of each DTensor leaf of ``tree``, None for a
    plain one: the ``shardings`` of a restore onto the same layout."""
    return sharding.tree_map(lambda t: (t.device_mesh, tuple(t.placements))
                             if sharding.is_dtensor(t) else None, tree)


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
          heartbeat: Optional[Callable[[int, float], None]] = None,
          mesh=None) -> LMTrainResult:
    """Train ``cfg`` to ``steps`` steps on synthetic token batches of
    ``batch`` x ``seq``, from random parameters drawn from ``seed`` or the
    latest checkpoint under ``ckpt_dir``; checkpoint every ``ckpt_every``
    steps. The batches hold tokens only, as the reference launcher's do: a
    VLM (phi-3-vision) trains text-only, and an encoder-decoder (whisper)
    raises ``models.lm.forward``'s ``ValueError`` at its first step, its
    batch needing encoder frames (train it through ``lm_loss`` and
    ``make_lm_step`` with a batch that holds them). ``heartbeat(step, seconds)`` is called after every step. A run
    whose latest checkpoint is already at ``steps`` returns at once, with no
    steps and no losses.

    ``mesh``: a ``DeviceMesh`` over the process group's ranks (its device
    type ``device``'s): parameters drawn whole from ``seed`` and then split
    over it (``shard_params``), the steps run under ``sharding.use_mesh``,
    batches split on their batch dim, checkpoints gathered on save and
    split again on resume. None: the one-device path."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"train: a {mesh.device_type} mesh for a {dev.type} "
                         "run")
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
    with (sharding.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        return _train(cfg, params, steps=steps, batch=batch, seq=seq, lr=lr,
                      ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      compress_grads=compress_grads, dev=dev,
                      log_every=log_every, heartbeat=heartbeat, mesh=mesh)


def _train(cfg, params, *, steps, batch, seq, lr, ckpt_dir, ckpt_every,
           compress_grads, dev, log_every, heartbeat, mesh) -> LMTrainResult:
    lr_fn = optim.cosine_schedule(lr, warmup=max(1, steps // 10), total=steps)
    step_fn = loop.make_lm_step(cfg, params, lr_fn,
                                compress_grads=compress_grads)
    opt_state = optim.adamw_init(params_mod.flatten(params))

    start = 0
    if ckpt_dir and ckpt_mod.latest_step(ckpt_dir) is not None:
        like = train_tree(params, opt_state)
        tree, start, _ = ckpt_mod.restore(
            ckpt_dir, like, shardings=shardings_of(like) if mesh else None)
        opt_state = _load(params, tree, dev)
        print(f"resumed from step {start}")

    batches = synthetic.token_batches(batch, seq, cfg.vocab_size,
                                      start_idx=start * batch)
    bspec = sharding.resolve_spec(("batch", "seq"))
    losses, times = [], []
    for step in range(start, steps):
        t0 = time.monotonic()
        b, loader_idx = next(batches)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if mesh is not None:
            b = {k: sharding.distribute(
                v, sharding.fix_spec(bspec, v.shape, mesh), mesh)
                for k, v in b.items()}
        opt_state, metrics = step_fn(opt_state, b, step)
        loss = float(sharding.whole(metrics["loss"]))
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
    p.add_argument("--mesh", default=None,
                   choices=["auto", "production", "multipod"])
    a = p.parse_args(argv)

    # f32 convolutions (Mamba's causal conv) in full f32, not cuDNN's TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke(a.arch) if a.smoke else get_config(a.arch)
    kind = a.mesh or ("auto" if int(os.environ.get("WORLD_SIZE", "1")) > 1
                      else None)
    if kind is None:
        print(f"arch={cfg.name} device={a.device} "
              f"params={cfg.param_count():,}")
        res = train(cfg, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr,
                    ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                    compress_grads=a.compress_grads, device=a.device)
        print("done")
        return res
    import torch.distributed as dist
    device = init_group(a.device)
    try:
        mesh = build_mesh(kind, device.type)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"arch={cfg.name} device={device.type} mesh="
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                  f"params={cfg.param_count():,}")
        res = train(cfg, steps=a.steps, batch=a.batch, seq=a.seq, lr=a.lr,
                    ckpt_dir=a.ckpt_dir, ckpt_every=a.ckpt_every,
                    compress_grads=a.compress_grads, device=device,
                    log_every=10 if rank0 else 0, mesh=mesh)
        if rank0:
            print("done")
        return res
    finally:
        dist.destroy_process_group()


def init_group(device: DeviceLike) -> torch.device:
    """The process group of a torchrun launch, from its environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL with this
    rank's card for ``cuda``, gloo for ``cpu``. Returns the rank's device.
    Raises without torchrun's environment."""
    import torch.distributed as dist
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--mesh runs under torchrun: {missing} not set "
                           "(torchrun --nproc-per-node=N -m "
                           "repro_torch.launch.train ... --mesh auto)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=600))
    return dev


def build_mesh(kind: str, device_type: str):
    """The mesh ``--mesh`` names over the process group: ``auto`` as the
    reference's (``min(4, ranks)`` model parallelism, gcd rule),
    ``production``/``multipod`` the production meshes."""
    import torch.distributed as dist
    if kind == "auto":
        n = dist.get_world_size()
        return mesh_mod.make_mesh_from_ranks(model_parallel=min(4, n),
                                             device_type=device_type)
    return mesh_mod.make_production_mesh(multi_pod=kind == "multipod",
                                         device_type=device_type)


if __name__ == "__main__":
    main()
