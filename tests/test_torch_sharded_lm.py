"""The port's sharded LM path on four CPU ranks, held to the reference.

The reference runs in this process while the four ranks run. One spawn
of four gloo ranks (a ``file://`` store under ``tmp_path``, a
60 s timeout) over a (2, 2) ("data", "model") mesh runs every sharded check
here; rank 0 writes what it saw to ``tmp_path`` and this process holds it
to the reference's UNSHARDED functions (the reference's own sharded
dry-run does not run on this tree):

- smoke Llama, Mixtral and Mamba in f32, the same parameters and numpy
  inputs in both packages: the sharded forward's logits, ``lm_loss`` and
  every gradient against the reference's ``forward`` and
  ``jax.value_and_grad``, at the tolerances tests/test_torch_lm_train.py
  and tests/test_torch_lm_archs.py hold the unsharded port to (logits 1e-4
  of their scale, gradients 1e-4 of the largest entry; the named
  ill-conditioned leaves, any leaf of a MoE config, and logits that miss
  the tight bound (as tests/test_torch_lm_encdec_vlm.py holds Whisper's)
  no further from the f64 evaluation than GRAD_K times the reference's own
  f32 distance, + 1e-4);
- Mixtral's dispatch (experts, slots, the (E, C) token buffer) index for
  index against the reference's routing lines on the same router logits:
  routed on all tokens, not per data shard;
- three training steps of smoke Llama through
  ``launch.train.train(mesh=...)`` against the unsharded launcher, by
  loss (f32 parameters), with and without INT8 gradient compression;
- ``checkpoint.restore(shardings=...)`` of a checkpoint the reference
  wrote and of one the sharded run wrote: the tree it returns, gathered,
  equals the saved tree exactly;
- ``tools/mesh_sweep.sharded_decode``: six decode steps of smoke
  DeepSeek (4 kv heads, split over "model") and smoke Whisper (its
  cross-attention over a filled cross cache) on the mesh, the cache and
  batch placed by ``dryrun.place``, against the unsharded port's decode
  (held to the reference by tests/test_torch_lm_archs.py and
  test_torch_lm_encdec_vlm.py) within FWD_TOL of the logits' scale.
"""
import dataclasses
import datetime
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs as tconfigs
from repro_torch.models import lm
from repro_torch.models.params import flatten, unflatten
from tools.mesh_sweep import DECODE_ARCHS, sharded_decode

ARCHS = ["llama3.2-1b", "mixtral-8x7b", "mamba2-1.3b"]
MOE = {"mixtral-8x7b"}
B = 2
# each arch's batch (seed, S) is the one its unsharded gradient test holds
# the port on: tests/test_torch_lm_train.py's (seed 1, S = 64: two of the
# Mamba smoke config's 32-token chunks) and tests/test_torch_lm_archs.py's
# for Mixtral (seed 2, S = 32)
BATCH = {"llama3.2-1b": (1, 64), "mixtral-8x7b": (2, 32),
         "mamba2-1.3b": (1, 64)}
S = 64                  # the training runs' sequence
WORLD, MESH = 4, (2, 2)
FWD_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
GRAD_K = {"dense": 2.0, "moe": 4.0}
ILL_CONDITIONED = {"embed", "blocks.blk0.ssm.conv_w"}
STEP_RTOL = 1e-4        # three f32 steps, as test_torch_lm_train.py
STEPS, TRAIN_B = 3, 2
TIMEOUT_S = 240


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)


def _jcfg(arch):
    from repro import configs as jconfigs
    return dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")


def _batch(vocab, seed, seq):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, seq + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# the four ranks
# ---------------------------------------------------------------------------

def _f32_params(init):
    def f32(*a, **kw):
        return unflatten({k: t.float() for k, t in
                          flatten(init(*a, **kw)).items()})
    return f32


def _rank(rank, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    try:
        _checks(rank, out_dir)
    finally:
        dist.destroy_process_group()


def _checks(rank, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.train import checkpoint as ckpt
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    res = {}

    plans = []
    plan = L._moe_plan

    def recorded(cfg, logits, dtype):
        out = plan(cfg, logits, dtype)
        plans.append((logits.detach().numpy().copy(),
                      out[2].numpy().copy(), out[3].numpy().copy(),
                      out[4].numpy().copy()))
        return out
    L._moe_plan = recorded

    # forward, loss and every gradient, sharded, from the reference's tree
    for arch in ARCHS:
        cfg = _cfg(arch)
        data = np.load(os.path.join(out_dir, f"{arch}.npz"))
        params = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                            if k.startswith("p.")})
        batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
        dparams = launch_train.shard_params(cfg, params, mesh)
        flat = flatten(dparams)
        for p in flat.values():
            p.requires_grad_(True)
        with sh.use_mesh(mesh):
            spec = sh.resolve_spec(("batch", "seq"))
            dbatch = {k: sh.distribute(v, spec, mesh)
                      for k, v in batch.items()}
            plans.clear()
            loss, _ = lm.lm_loss(cfg, dparams, dbatch)
            loss.backward()
            logits, _ = lm.forward(cfg, dparams, dbatch["tokens"])
            logits = sh.whole(logits.detach())
        grads = {k: sh.whole(p.grad).numpy() for k, p in flat.items()}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{arch}.port.npz"),
                     logits=logits.numpy(), loss=float(sh.whole(loss)),
                     **{"g." + k: v for k, v in grads.items()})
            if arch in MOE:
                np.savez(os.path.join(out_dir, f"{arch}.plans.npz"),
                         **{f"{i}.{n}": a for i, p in enumerate(plans[:2])
                            for n, a in zip(("logits", "eidx", "pos",
                                             "tok_buf"), p)})
    L._moe_plan = plan

    # three steps through the launcher, sharded and not, f32 parameters
    lm.init_params = _f32_params(lm.init_params)
    runs = [("llama3.2-1b", False), ("llama3.2-1b", True)]
    for arch, comp in runs:
        cfg = _cfg(arch)
        kw = dict(steps=STEPS, batch=TRAIN_B, seq=S, device="cpu",
                  compress_grads=comp, log_every=0)
        d = os.path.join(out_dir, f"ckpt-{arch}-{comp}")
        got = launch_train.train(cfg, mesh=mesh, ckpt_dir=d,
                                 ckpt_every=STEPS, **kw)
        want = launch_train.train(cfg, **kw)
        res[f"{arch}/{comp}"] = {"sharded": got.losses,
                                 "unsharded": want.losses}
        if comp or arch != "llama3.2-1b":
            continue
        # the sharded run's checkpoint, back onto the mesh and plain
        like = launch_train.train_tree(got.params, got.opt_state)
        whole = {k: sh.whole(v).detach() for k, v in
                 _flat_tree(like).items()}
        back, step, _ = ckpt.restore(d, like,
                                     shardings=launch_train.shardings_of(like))
        plain, _, _ = ckpt.restore(d, like)
        res["sharded_ckpt"] = {
            "step": step,
            "exact": all(torch.equal(sh.whole(v), whole[k])
                         for k, v in _flat_tree(back).items()),
            "dtensors": all(sh.is_dtensor(v) for k, v in
                            _flat_tree(back["p"]).items()),
            "plain_exact": all(torch.equal(v, whole[k]) for k, v in
                               _flat_tree(plain).items())}

    # a checkpoint the reference wrote, restored onto the mesh
    cfg = _cfg("llama3.2-1b")
    data = np.load(os.path.join(out_dir, "llama3.2-1b.npz"))
    params = unflatten({k[2:]: torch.from_numpy(data[k]) for k in data
                        if k.startswith("p.")})
    dparams = launch_train.shard_params(cfg, params, mesh)
    tree, _, _ = ckpt.restore(
        os.path.join(out_dir, "ref_ckpt"), {"p": params},
        shardings=launch_train.shardings_of({"p": dparams}))
    res["ref_ckpt"] = {
        "exact": all(torch.equal(sh.whole(v), flatten(params)[k])
                     for k, v in flatten(tree["p"]).items()),
        "same_layout": all(
            tuple(v.placements) == tuple(flatten(dparams)[k].placements)
            for k, v in flatten(tree["p"]).items())}
    res["decode"] = {arch: sharded_decode(arch, mesh)
                     for arch in DECODE_ARCHS}
    if rank == 0:
        with open(os.path.join(out_dir, "res.json"), "w") as f:
            json.dump(res, f)


def _flat_tree(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat_tree(v, key + "."))
        elif torch.is_tensor(v):
            out[key] = v
    return out


# ---------------------------------------------------------------------------
# the reference, and the checks
# ---------------------------------------------------------------------------

def _jax_route(logits, E, topk, cf):
    """The reference's dispatch lines (layers.py:325-359), on logits."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    T = logits.shape[0]
    C = max(1, int(math.ceil(T * topk * cf / E)))
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, eidx = lax.top_k(probs, topk)
    flat_e = eidx.reshape(-1)
    flat_t = jnp.arange(T * topk, dtype=jnp.int32) // topk
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    tok_buf = jnp.full((E, C), T, dtype=jnp.int32)
    tok_buf = tok_buf.at[flat_e, pos].set(flat_t, mode="drop")
    return np.asarray(flat_e), np.asarray(pos), np.asarray(tok_buf)


def _reference(arch, params, batch):
    """The reference's f32 loss, logits and gradients (jitted), and the
    f64 evaluation (the port's unsharded f64, which the reference's agrees
    with within 1e-8: tests/test_torch_lm_train.py)."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    jcfg = _jcfg(arch)
    jp = unflatten({k: jnp.asarray(v) for k, v in params.items()})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(lambda p, b: jax.value_and_grad(
        jlm.lm_loss, has_aux=True, argnums=1)(jcfg, p, b))(jp, jb)
    logits, _ = jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        jp, jb["tokens"])
    cfg = _cfg(arch, "float64")
    tp = unflatten({k: torch.from_numpy(v.astype(np.float64))
                    for k, v in params.items()})
    flat = flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss64, _ = lm.lm_loss(cfg, tp, tb)
    loss64.backward()
    with torch.no_grad():
        logits64, _ = lm.forward(cfg, tp, tb["tokens"])
    return dict(loss=float(loss), logits=np.asarray(logits),
                grads={k: np.asarray(v, np.float32)
                       for k, v in flatten(g).items()},
                g64={k: p.grad.numpy() for k, p in flat.items()},
                logits64=logits64.numpy())


def _write_inputs(out_dir):
    """Each arch's f32 parameters (the reference's tree from key 0, the
    one tests/test_torch_lm_train.py holds the port on) and numpy batch;
    the Llama tree as the reference's checkpoint."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    from repro.models.params import materialize
    from repro.train import checkpoint as jckpt
    inputs = {}
    for arch in ARCHS:
        defs = jlm.param_defs(_jcfg(arch))
        jp = jax.jit(lambda key: jax.tree.map(
            lambda a: a.astype("float32"), materialize(defs, key)))(
                jax.random.key(0))
        params = {k: np.asarray(v) for k, v in flatten(jp).items()}
        batch = _batch(_cfg(arch).vocab_size, *BATCH[arch])
        np.savez(os.path.join(out_dir, f"{arch}.npz"), **batch,
                 **{"p." + k: v for k, v in params.items()})
        inputs[arch] = (params, batch)
    jckpt.save(os.path.join(out_dir, "ref_ckpt"), 1, {"p": unflatten(
        {k: jnp.asarray(v) for k, v in inputs["llama3.2-1b"][0].items()})})
    return inputs


def _wait(ctx):
    waited = 0
    while not ctx.join(timeout=1):
        waited += 1
        if waited > TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the four ranks did not finish in {TIMEOUT_S} s")


def test_sharded_lm_on_four_gloo_ranks_matches_the_reference(tmp_path):
    inputs = _write_inputs(str(tmp_path))
    ctx = mp.start_processes(_rank, args=(str(tmp_path),), nprocs=WORLD,
                             join=False, start_method="spawn")
    try:
        want = {arch: _reference(arch, *inputs[arch]) for arch in ARCHS}
    finally:
        _wait(ctx)
    res = json.loads((tmp_path / "res.json").read_text())

    for arch in ARCHS:
        got = np.load(tmp_path / f"{arch}.port.npz")
        w = want[arch]
        k_f64 = GRAD_K["moe" if arch in MOE else "dense"]
        scale = max(1.0, float(np.abs(w["logits"]).max()))
        off = float(np.abs(got["logits"] - w["logits"]).max())
        if off > FWD_TOL * scale:
            ref_off = float(np.abs(w["logits"] - w["logits64"]).max())
            port_off = float(np.abs(got["logits"] - w["logits64"]).max())
            assert port_off <= k_f64 * ref_off + FWD_TOL * scale, (
                arch, off, port_off, ref_off, scale)
        np.testing.assert_allclose(float(got["loss"]), w["loss"],
                                   rtol=LOSS_RTOL)
        gmax = max(float(np.abs(v).max()) for v in w["grads"].values())
        assert sorted(k[2:] for k in got if k.startswith("g.")) == \
            sorted(w["grads"])
        for k, gj in w["grads"].items():
            gt = got["g." + k]
            assert gt.shape == gj.shape, (arch, k)
            off = float(np.abs(gt - gj).max())
            if off <= GRAD_TOL * gmax:
                continue
            assert k in ILL_CONDITIONED or arch in MOE, (arch, k, off, gmax)
            ref_off = float(np.abs(gj - w["g64"][k]).max())
            port_off = float(np.abs(gt - w["g64"][k]).max())
            assert port_off <= k_f64 * ref_off + GRAD_TOL * gmax, (
                arch, k, port_off, ref_off)

    # Mixtral: every MoE layer's routing equals the reference's on the
    # logits it saw, over all B*S tokens
    jcfg = _jcfg("mixtral-8x7b")
    plans = np.load(tmp_path / "mixtral-8x7b.plans.npz")
    n_layers = len({k.split(".")[0] for k in plans})
    assert n_layers >= 1
    for i in range(n_layers):
        logits = plans[f"{i}.logits"]
        assert logits.shape == (B * BATCH["mixtral-8x7b"][1],
                                jcfg.num_experts)
        flat_e, pos, tok_buf = _jax_route(logits, jcfg.num_experts,
                                          jcfg.experts_per_token,
                                          jcfg.capacity_factor)
        np.testing.assert_array_equal(plans[f"{i}.eidx"], flat_e)
        np.testing.assert_array_equal(plans[f"{i}.pos"], pos)
        np.testing.assert_array_equal(plans[f"{i}.tok_buf"], tok_buf)

    for key, run in res.items():
        if "/" not in key:
            continue
        assert len(run["sharded"]) == STEPS
        np.testing.assert_allclose(run["sharded"], run["unsharded"],
                                   rtol=STEP_RTOL, err_msg=key)
    assert res["sharded_ckpt"] == {"step": STEPS, "exact": True,
                                   "dtensors": True, "plain_exact": True}
    assert res["ref_ckpt"] == {"exact": True, "same_layout": True}
    for arch in DECODE_ARCHS:
        got = res["decode"][arch]
        assert got["kv_heads_split"] and got["off"] <= FWD_TOL, (arch, got)
