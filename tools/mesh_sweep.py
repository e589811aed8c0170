#!/usr/bin/env python3
"""The port's sharded LM paths on small meshes, with the port alone (no
JAX), under whatever torch the host has: DTensor's view and op rules differ
between torch releases, so a path that runs under one may refuse under
another.

    PYTHONPATH=src python tools/mesh_sweep.py [--cells f4] [--no-ranks]

1. ``launch.dryrun.trace`` of a train_4k, prefill_32k and decode_32k step
   at small shapes (S=64, B=4) of every smoke LM architecture, and of
   whisper with one kv head, on the (1, 1), (4, 1), (2, 2) and (1, 4) fake
   meshes (``cells()``, tests/test_torch_dryrun.py's cells); with
   ``--cells f4`` only the F4_CELLS, those torch 2.11's DTensor refused
   before the decode and cross-attention tile ran per shard;
2. a smoke Llama decode step on a one-rank gloo mesh, placed by
   ``dryrun.place``, against the unsharded step, bit for bit;
3. (not with ``--no-ranks``) ``sharded_decode`` of DeepSeek and Whisper on
   a (2, 2) mesh of four gloo ranks against the unsharded decode, within
   DECODE_TOL of the logits' scale (tests/test_torch_sharded_lm.py runs
   the same function in its ranks).

Prints one line a part and exits 1 if any part fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SMALL = {"train_4k": (64, 4, "train"), "prefill_32k": (64, 4, "prefill"),
         "decode_32k": (64, 4, "decode")}
MESHES = [(1, 1), (4, 1), (2, 2), (1, 4)]
KV1 = "whisper-small/kv1"       # whisper's smoke config with one kv head
# the cells torch 2.11's DTensor refused with F3 repaired: it would not
# flatten (B, K) with the kv heads split over "model" (ROADMAP, F4)
F4_CELLS = ([(a, m, "decode_32k") for a in ("phi-3-vision-4.2b",
                                            "deepseek-7b")
             for m in ((2, 2), (1, 4))]
            + [("gemma2-9b", (2, 2), "decode_32k")]
            + [("whisper-small", m, s) for m in ((2, 2), (1, 4))
               for s in SMALL])
DECODE_ARCHS = ["deepseek-7b", "whisper-small"]
DECODE_B, DECODE_S, DECODE_STEPS = 4, 16, 6
DECODE_TOL = 1e-4


def cells():
    """Part 1's cells, (architecture, mesh shape, shape): every smoke LM
    on the meshes a one-node run makes, a 1-way axis (where a split the
    divisibility rule keeps over it is no split, F3) and each axis 4-way;
    whisper again with one kv head (the one-kv-head smoke configs' dim of
    size 1 in its cross-attention) on the first two."""
    from repro_torch import configs as C
    return ([(a, m, s) for a in C.LM_ARCHS for m in MESHES for s in SMALL]
            + [(KV1, m, s) for m in MESHES[:2] for s in SMALL])


def smoke_cfg(name):
    """The smoke config of a cell's architecture (``KV1``: one kv head)."""
    from repro_torch import configs as C
    arch, _, kv = name.partition("/")
    cfg = C.get_smoke(arch)
    return dataclasses.replace(cfg, num_kv_heads=1) if kv else cfg


@contextlib.contextmanager
def use_shapes(shapes):
    """``configs.SHAPES`` with ``shapes`` in place of its cells (which
    ``launch.dryrun`` and ``launch.mesh`` look up), restored after."""
    from repro_torch import configs as C
    old = {k: C.SHAPES[k] for k in shapes}
    C.SHAPES.update(shapes)
    try:
        yield
    finally:
        C.SHAPES.update(old)


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def trace_cell(name, mesh_shape, shape):
    """``dryrun.trace`` of one cell on a fake group of the mesh's ranks:
    (cost tally, outputs, the mesh). The caller sets the shapes
    (``use_shapes``)."""
    from repro_torch.launch import dryrun
    with dryrun.fake_group(mesh_shape[0] * mesh_shape[1]):
        mesh = _mesh(mesh_shape)
        tally, out, _ = dryrun.trace(smoke_cfg(name), shape, mesh)
    return tally, out, mesh


def trace_cells(todo, shapes=SMALL):
    """Part 1: the cells of ``todo`` that raise, as (name, mesh, shape,
    error)."""
    bad = []
    with use_shapes(shapes):
        for name, mesh_shape, shape in todo:
            try:
                trace_cell(name, mesh_shape, shape)
            except Exception as e:  # noqa: BLE001 - listed
                bad.append((name, mesh_shape, shape, str(e)[:160]))
    return bad


def one_rank_decode(shapes=SMALL) -> bool:
    """Part 2: the one-rank decode step equals the unsharded one."""
    from repro_torch import configs as C
    from repro_torch import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.params import flatten
    with use_shapes(shapes):
        step_fn, meta_args, axes = dryrun.build_step(
            C.get_smoke("llama3.2-1b"), "decode_32k")
    g = torch.Generator().manual_seed(0)

    def real(t):
        if not torch.is_tensor(t):
            return t
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=g).to(t.dtype)
        return torch.randint(0, 64, t.shape, generator=g, dtype=t.dtype)

    args = sharding.tree_map(real, meta_args)
    plain = sharding.tree_map(
        lambda t: t.clone() if torch.is_tensor(t) else t, args)
    with tempfile.TemporaryDirectory() as d:
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{os.path.join(d, 'store')}",
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = _mesh((1, 1))
            with sharding.use_mesh(mesh):
                logits, cache = step_fn(**dryrun.place(args, axes, mesh))
        finally:
            torch.distributed.destroy_process_group()
    want_logits, want_cache = step_fn(**plain)
    want = flatten(want_cache)
    return torch.equal(sharding.whole(logits), want_logits) and all(
        torch.equal(sharding.whole(v), want[k])
        for k, v in flatten(cache).items())


def sharded_decode(arch: str, mesh) -> dict:
    """DECODE_STEPS f32 decode steps of ``arch``'s smoke config on
    ``mesh`` (the cache and batch placed by ``dryrun.place``; whisper's
    cross cache filled from its encoder over random frames) and unsharded,
    every rank drawing the same weights and inputs: the largest logit
    difference over the logits' scale, and whether the kv-head dim of the
    first k cache is split."""
    from repro_torch import configs as C
    from repro_torch import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.models.params import flatten, logical_axes, unflatten
    cfg = dataclasses.replace(C.get_smoke(arch), dtype="float32")
    params = unflatten({k: t.float() for k, t in flatten(lm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")).items()})
    cache = lm.init_cache(cfg, DECODE_B, DECODE_S, device="cpu")
    if cfg.encoder_layers:
        frames = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (DECODE_B, cfg.num_encoder_frames, cfg.d_model)).astype(
                np.float32))
        with torch.no_grad():
            enc = lm.encoder_kv(cfg, params, lm.encode(cfg, params, frames))
        for j, (k, v) in enumerate(zip(enc["k"], enc["v"])):
            cache[f"blk{j}"]["xk"], cache[f"blk{j}"]["xv"] = k, v
    dparams = launch_train.shard_params(cfg, params, mesh)
    dcache = dryrun.place(
        sh.tree_map(torch.clone, cache),
        logical_axes(lm.cache_defs(cfg, DECODE_B, DECODE_S)), mesh)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (DECODE_B, DECODE_STEPS))
    off, scale = 0.0, 1.0
    with torch.no_grad():
        for s in range(DECODE_STEPS):
            tok = torch.from_numpy(toks[:, s:s + 1])
            pos = torch.full((DECODE_B,), s)
            want, cache = lm.decode_step(cfg, params, cache, tok, pos)
            with sh.use_mesh(mesh):
                b = dryrun.place({"tokens": tok, "position": pos},
                                 mesh_mod.input_axes(cfg, "decode_32k"),
                                 mesh)
                got, dcache = lm.decode_step(cfg, dparams, dcache,
                                             b["tokens"], b["position"])
                got = sh.whole(got)
            off = max(off, float((got - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
    split = any(p.is_shard(3) for p in dcache["blk0"]["k"].placements)
    return {"off": off / scale, "kv_heads_split": split}


def _rank(rank, out_dir):
    torch.set_num_threads(1)
    import json
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = _mesh((2, 2))
        res = {arch: sharded_decode(arch, mesh) for arch in DECODE_ARCHS}
        if rank == 0:
            with open(os.path.join(out_dir, "res.json"), "w") as f:
                json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def four_rank_decode() -> dict:
    """Part 3: ``sharded_decode`` on four spawned gloo ranks."""
    import json
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank, args=(out_dir,), nprocs=4,
                           start_method="spawn")
        with open(os.path.join(out_dir, "res.json")) as f:
            return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", choices=("all", "f4"), default="all",
                   help="part 1's cells: all, or only F4_CELLS")
    p.add_argument("--no-ranks", action="store_true",
                   help="skip part 3 (four spawned gloo ranks)")
    a = p.parse_args(argv)
    todo = cells() if a.cells == "all" else F4_CELLS
    t = time.perf_counter()
    bad = trace_cells(todo)
    n = len(todo)
    print(f"mesh_sweep torch {torch.__version__}: {n - len(bad)} of {n} "
          f"cells traced in {time.perf_counter() - t:.1f} s; failed: {bad}")
    ok = not bad
    same = one_rank_decode()
    print(f"mesh_sweep one-rank decode step bit for bit: {same}")
    ok &= same
    if not a.no_ranks:
        res = four_rank_decode()
        print(f"mesh_sweep decode on a (2, 2) mesh of four gloo ranks, "
              f"largest logit difference over the scale (at most "
              f"{DECODE_TOL}): {res}")
        ok &= all(r["kv_heads_split"] and r["off"] <= DECODE_TOL
                  for r in res.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
