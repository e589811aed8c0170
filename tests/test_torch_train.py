"""repro_torch.train against repro.train, and the XR training path of the
port against the reference's, on the CPU.

Twins of tests/test_train_infra.py (optimizers, clipping, the schedule,
checkpoints, compression) and of tests/test_system.py's training halves,
then the same numpy inputs through both packages: optimizer updates,
compression codes, the losses, one step's gradients, a few steps' loss
trajectory, and checkpoints that cross between the packages bit for bit.

Tolerances, where the packages round otherwise:
  * one step's gradients: |g_port - g_jax| <= GRAD_TOL x the net's largest
    gradient entry, absolute. Leaves whose exact gradient is zero (a bias
    ahead of a train-mode BN with only a 1x1 conv between) carry rounding
    noise of either sign in both packages, so a per-leaf relative tolerance
    means nothing there; and the reference's own f32 gradient is off an
    f64 evaluation by up to 1.9e-5 of the largest entry (smoke EDSNet).
  * loss trajectories: AdamW's first step divides by |g|, so on those
    leaves noise becomes a step of +-lr in either package. Where they
    cancel out of the loss exactly (DetNet) the losses agree to TRAJ_RTOL;
    EDSNet's skips carry such biases into 3x3 convs, whose zero padding
    leaves them a border gradient at the noise level, and the +-lr steps
    move its loss by up to 5e-5 relative in six steps (measured), so it is
    held to TRAJ_RTOL_EDSNET.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xr as jxr
from repro.train import checkpoint as jckpt
from repro.train import compress as jcompress
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic
from repro_torch.launch import train_xr
from repro_torch.models import xr
from repro_torch.models.params import (from_jax, to_jax, xr_train_from_jax,
                                       xr_train_to_jax)
from repro_torch.quant import ptq
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress, loop, optim

GRAD_TOL = 1e-4
TRAJ_RTOL = 1e-5
TRAJ_RTOL_EDSNET = 2e-4
LOSSES = {"detnet": (jxr.circle_loss, xr.circle_loss),
          "edsnet": (jxr.dice_loss, xr.dice_loss)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# twins of tests/test_train_infra.py
# ---------------------------------------------------------------------------

def _quad_problem():
    params = {"w": torch.tensor([2.0, -3.0, 1.0]), "b": torch.tensor(4.0)}

    def grads(p):
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        (torch.sum(ps["w"] ** 2) + ps["b"] ** 2).backward()
        return {k: v.grad for k, v in ps.items()}

    def loss(p):
        return float(torch.sum(p["w"] ** 2) + p["b"] ** 2)
    return params, grads, loss


def test_adamw_converges_on_quadratic():
    params, grads, loss = _quad_problem()
    state = optim.adamw_init(params)
    for _ in range(300):
        params, state = optim.adamw_update(grads(params), state, params,
                                           lr=5e-2, weight_decay=0.0)
    assert loss(params) < 1e-3


def test_sgd_converges_on_quadratic():
    params, grads, loss = _quad_problem()
    state = optim.sgd_init(params)
    for _ in range(200):
        params, state = optim.sgd_update(grads(params), state, params,
                                         lr=2e-2)
    assert loss(params) < 1e-3


@pytest.mark.parametrize("max_norm", [0.1, 0.37, 1.0, 2.5, 10.0])
def test_clip_by_global_norm_bound(max_norm):
    g = {"a": torch.full((4,), 3.0), "b": torch.full((2, 2), -5.0)}
    clipped, n = optim.clip_by_global_norm(g, max_norm)
    assert float(optim.global_norm(clipped)) <= max_norm * (1 + 1e-5)


def test_cosine_schedule_shape():
    f = optim.cosine_schedule(1.0, warmup=10, total=100)
    assert float(f(0)) == 0.0
    assert abs(float(f(10)) - 1.0) < 0.11
    assert float(f(100)) < 0.01


def test_checkpoint_roundtrip(tmp_path):
    tree = {"p": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": optim.adamw_init({"w": torch.zeros(2, 3)})}
    ckpt.save(str(tmp_path), 7, tree, extra={"loader_idx": 42})
    out, step, extra = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and extra["loader_idx"] == 42
    assert torch.equal(out["p"]["w"], tree["p"]["w"])
    assert isinstance(out["opt"], optim.AdamWState)
    assert out["opt"].count.dtype == torch.int32


def test_checkpoint_resume_latest_and_prune(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"x": torch.full((3,), float(s))},
                  keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    out, step, _ = ckpt.restore(str(tmp_path), tree)
    assert step == 5 and float(out["x"][0]) == 5.0
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp directory must never be picked up by restore."""
    os.makedirs(tmp_path / "step_0000000009.tmp")
    ckpt.save(str(tmp_path), 3, {"x": torch.ones(2)})
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_async_matches_sync(tmp_path):
    x = torch.arange(4.0)
    t = ckpt.save_async(str(tmp_path), 1, {"x": x})
    x.add_(100.0)                   # the snapshot was taken before the thread
    t.join()
    out, step, _ = ckpt.restore(str(tmp_path), {"x": x})
    assert torch.equal(out["x"], torch.arange(4.0))


def test_compress_error_feedback_unbiased():
    """Dequantized codes plus the carried error equal the true gradient
    sum: error feedback leaks nothing."""
    rng = np.random.default_rng(0)
    err = compress.init_error({"g": torch.zeros(64)})
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(20):
        g = {"g": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
        total_true += g["g"].numpy()
        q, s, err = compress.compress(g, err)
        total_sent += compress.decompress(q, s)["g"].numpy()
    assert np.max(np.abs(total_true - (total_sent + err["g"].numpy()))) < 1e-4


def test_compress_codes_are_int8():
    g = {"g": torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 8)).astype(np.float32) * 10)}
    q, s, _ = compress.compress(g, compress.init_error(g))
    assert q["g"].dtype == torch.int8
    assert float(s["g"]) > 0


def test_training_with_compression_still_converges():
    params = {"w": torch.tensor([5.0, -5.0])}
    state = optim.adamw_init(params)
    err = compress.init_error(params)
    for _ in range(200):
        q, s, err = compress.compress({"w": 2 * params["w"]}, err)
        params, state = optim.adamw_update(compress.decompress(q, s), state,
                                           params, lr=5e-2, weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


# ---------------------------------------------------------------------------
# the same numpy inputs through both packages
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": (rng.normal(size=(3, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32),
            "c": np.float32(rng.normal() * scale)}


def test_adamw_update_matches_reference():
    """Three steps with the schedule's lr: params, moments and count agree
    (the same f32 operations in the same order; pow and sqrt may differ in
    the last ulp between XLA and PyTorch)."""
    rng = np.random.default_rng(2)
    p_np = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p_np), {k: _t(v) for k, v in
                                               p_np.items()}
    js, ts = joptim.adamw_init(jp), optim.adamw_init(tp)
    jlr = joptim.cosine_schedule(3e-3, 2, 10)
    tlr = optim.cosine_schedule(3e-3, 2, 10)
    for step in range(3):
        g = _tree(rng, scale=10.0 ** (step - 1))
        jp, js = joptim.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                     lr=jlr(jnp.asarray(step + 1)))
        tp, ts = optim.adamw_update({k: _t(v) for k, v in g.items()}, ts, tp,
                                    lr=float(tlr(step + 1)))
    for k in p_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                   rtol=1e-6)
    assert int(ts.count) == int(js.count) == 3
    assert ts.count.dtype == torch.int32


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(3)
    p_np = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p_np), {k: _t(v) for k, v in
                                               p_np.items()}
    js, ts = joptim.sgd_init(jp), optim.sgd_init(tp)
    for _ in range(3):
        g = _tree(rng)
        jp, js = joptim.sgd_update(jax.tree.map(jnp.asarray, g), js, jp,
                                   lr=1e-2)
        tp, ts = optim.sgd_update({k: _t(v) for k, v in g.items()}, ts, tp,
                                  lr=1e-2)
    for k in p_np:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9)
    assert int(ts.count) == int(js.count)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 100.0])
def test_clip_and_global_norm_match_reference(max_norm):
    g = _tree(np.random.default_rng(4))
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
    tc, tn = optim.clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                       max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


def test_cosine_schedule_matches_reference():
    """The same f32 formula; XLA's and PyTorch's cos may differ by an ulp,
    which 1 + cos(pi prog) magnifies near the schedule's end, so the
    tolerance is absolute in units of the base lr."""
    for base, warm, total in ((3e-3, 3, 20), (1.0, 10, 100), (1e-3, 1, 1)):
        jf = joptim.cosine_schedule(base, warm, total)
        tf = optim.cosine_schedule(base, warm, total)
        for s in range(total + 2):
            got, want = tf(s), jf(jnp.asarray(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=1e-6 * base)


def test_compress_matches_reference_exactly():
    """Codes, scales and the carried error bit for bit over three steps
    (the scale is a true f32 division and rounding is half to even in
    both)."""
    rng = np.random.default_rng(5)
    g0 = _tree(rng)
    je = jcompress.init_error(jax.tree.map(jnp.asarray, g0))
    te = compress.init_error({k: _t(v) for k, v in g0.items()})
    for _ in range(3):
        g = _tree(rng, scale=3.0)
        jq, js, je = jcompress.compress(jax.tree.map(jnp.asarray, g), je)
        tq, ts, te = compress.compress({k: _t(v) for k, v in g.items()}, te)
        for k in g:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
        jd = jcompress.decompress(jq, js)
        td = compress.decompress(tq, ts)
        for k in g:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def _loss_inputs(rng, B=4):
    det = {"center": rng.normal(size=(B, 4)).astype(np.float32),
           "radius": rng.normal(size=(B, 2)).astype(np.float32),
           "label": rng.normal(size=(B, 2)).astype(np.float32) * 3}
    det_batch = {"center": rng.random((B, 2, 2), dtype=np.float32),
                 "radius": rng.random((B, 2), dtype=np.float32),
                 "label": rng.integers(0, 2, B).astype(np.int32)}
    seg = {"mask": rng.normal(size=(B, 8, 12, 4)).astype(np.float32) * 2}
    seg_batch = {"mask": rng.integers(0, 4, (B, 8, 12)).astype(np.int32)}
    return det, det_batch, seg, seg_batch


def _both(fn_j, fn_t, outs, batch):
    want = fn_j({k: jnp.asarray(v) for k, v in outs.items()},
                {k: jnp.asarray(v) for k, v in batch.items()})
    got = fn_t({k: _t(v) for k, v in outs.items()},
               {k: _t(v) for k, v in batch.items()})
    return got, want


def test_circle_loss_matches_reference():
    det, det_batch, _, _ = _loss_inputs(np.random.default_rng(6))
    (got, gm), (want, wm) = _both(jxr.circle_loss, xr.circle_loss, det,
                                  det_batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert set(gm) == set(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_dice_loss_matches_reference():
    _, _, seg, seg_batch = _loss_inputs(np.random.default_rng(7))
    (got, gm), (want, wm) = _both(jxr.dice_loss, xr.dice_loss, seg,
                                  seg_batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(gm["dice"]), float(wm["dice"]),
                               rtol=1e-6)
    zeros = {"mask": torch.zeros(2, 8, 8, 4)}
    loss, _ = xr.dice_loss(zeros, {"mask": torch.zeros(2, 8, 8,
                                                       dtype=torch.int32)})
    assert 0.0 <= float(loss) <= 1.0


def test_iou_matches_reference():
    rng = np.random.default_rng(8)
    _, _, seg, seg_batch = _loss_inputs(rng)
    got, want = _both(jxr.iou, xr.iou, seg, seg_batch)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # a class absent from prediction and mask counts 1
    logits = np.zeros((1, 4, 4, 4), np.float32)
    logits[..., 0] = 1.0
    got, want = _both(jxr.iou, xr.iou, {"mask": logits},
                      {"mask": np.zeros((1, 4, 4), np.int32)})
    assert float(got) == float(want) == 1.0


# ---------------------------------------------------------------------------
# training through both packages
# ---------------------------------------------------------------------------

def _jax_tree(defs, seed):
    """A reference tree drawn with numpy under the reference's init rules
    (as tests/test_torch_xr.py draws it)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(defs):
        out[k] = {}
        for leaf in sorted(defs[k]):
            d = defs[k][leaf]
            if d.init in ("zeros", "ones"):
                a = np.full(d.shape, d.init == "ones", np.float32)
            else:
                a = (rng.standard_normal(d.shape) * d.scale
                     / np.sqrt(d.shape[0])).astype(np.float32)
            out[k][leaf] = a
    return out


def _setup(name):
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    pdefs, sdefs = jxr.param_defs(jcfg)
    params, state = _jax_tree(pdefs, 0), _jax_tree(sdefs, 1)
    net = xr.XRNet(tcfg, device="cpu")
    net.load_state_dict(from_jax(params, state))
    return jcfg, net, params, state


def _batches(cfg, batch=2):
    return train_xr.batches(cfg, batch)


@pytest.mark.parametrize("name", ["detnet", "edsnet"])
def test_one_step_gradients_match_jax_value_and_grad(name):
    """Loss and gradients of one train-mode step: the port's
    ``loss.backward()`` against ``jax.value_and_grad`` of the reference,
    held with the absolute tolerance of the module docstring."""
    jcfg, net, params, state = _setup(name)
    jloss, tloss = LOSSES[name]
    batch, _ = next(_batches(jcfg, 4))

    def loss_of(p):
        outs, _ = jxr.forward(jcfg, p, state, jnp.asarray(batch["image"]),
                              train=True)
        return jloss(outs, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    lj, gj = jax.value_and_grad(loss_of)(jax.tree.map(jnp.asarray, params))
    outs, _ = net(_t(batch["image"]), train=True)
    lt, _ = tloss(outs, {k: _t(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
    gt, _ = to_jax({k: p.grad for k, p in net.named_parameters()})
    gj = _np(gj)
    assert set(gt) == set(gj)
    gmax = max(float(np.abs(v).max()) for d in gj.values()
               for v in d.values())
    for step in gj:
        assert set(gt[step]) == set(gj[step])
        for leaf in gj[step]:
            np.testing.assert_allclose(gt[step][leaf], gj[step][leaf],
                                       rtol=0, atol=GRAD_TOL * gmax,
                                       err_msg=f"{step}.{leaf}")


@pytest.mark.parametrize("name", ["detnet", "edsnet"])
def test_loss_trajectory_and_cross_resume_match_reference(name, tmp_path):
    """Six steps of run_xr_training in each package from the same weights:
    the losses agree (module docstring). The reference's step-2 checkpoint
    then resumes in the port, which repeats the reference's steps 2-5."""
    jcfg, net, params, state = _setup(name)
    jloss, tloss = LOSSES[name]
    jres = jloop.run_xr_training(
        jcfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, state), _batches(jcfg), loss_fn=jloss,
        steps=6, lr=3e-3, ckpt_dir=str(tmp_path), ckpt_every=2,
        hooks=jloop.TrainHooks(log_every=0))
    tres = loop.run_xr_training(net, _batches(jcfg), loss_fn=tloss, steps=6,
                                lr=3e-3, hooks=loop.TrainHooks(log_every=0))
    rtol = TRAJ_RTOL if name == "detnet" else TRAJ_RTOL_EDSNET
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=rtol)
    assert tres.step == jres.step == 6
    for s in (4, 6):
        os.rename(tmp_path / f"step_{s:010d}", tmp_path / f"old_{s}")
    fresh = xr.XRNet(tconfigs.get_smoke(name), device="cpu")
    rres = loop.run_xr_training(fresh, _batches(jcfg), loss_fn=tloss,
                                steps=6, lr=3e-3, ckpt_dir=str(tmp_path),
                                ckpt_every=100,
                                hooks=loop.TrainHooks(log_every=0))
    assert len(rres.losses) == 4
    np.testing.assert_allclose(rres.losses, jres.losses[2:], rtol=TRAJ_RTOL)


def _opt_like(net, seed):
    rng = np.random.default_rng(seed)
    m = {k: _t(rng.normal(size=p.shape).astype(np.float32))
         for k, p in net.named_parameters()}
    v = {k: _t(rng.random(p.shape, dtype=np.float32))
         for k, p in net.named_parameters()}
    return m, v, torch.tensor(7, dtype=torch.int32)


def _assert_trees_equal(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(flat_b[path]))
        assert np.asarray(x).dtype == np.asarray(flat_b[path]).dtype


@pytest.mark.parametrize("name", ["detnet", "edsnet"])
def test_checkpoints_cross_between_the_packages_bit_exact(name, tmp_path):
    """A training tree saved by the reference restores in the port, and
    one saved by the port restores in the reference, bit for bit; both
    write the same keys."""
    _, net, params, state = _setup(name)
    m, v, count = _opt_like(net, 9)
    mine = xr_train_to_jax(net.state_dict(), m, v, count)
    theirs = {"params": jax.tree.map(jnp.asarray, mine["params"]),
              "state": jax.tree.map(jnp.asarray, mine["state"]),
              "opt": joptim.AdamWState(
                  jax.tree.map(jnp.asarray, mine["opt"]["m"]),
                  jax.tree.map(jnp.asarray, mine["opt"]["v"]),
                  jnp.asarray(np.int32(7)))}
    jckpt.save(str(tmp_path / "ref"), 3, theirs, extra={"loader_idx": 12})
    like = xr_train_to_jax(net.state_dict(), *_opt_like(net, 10))
    tree, step, extra = ckpt.restore(str(tmp_path / "ref"), like)
    assert step == 3 and extra == {"loader_idx": 12}
    sd, m2, v2, c2 = xr_train_from_jax(tree)
    for k, t in net.state_dict().items():
        assert torch.equal(sd[k], t), k
    for k in m:
        assert torch.equal(m2[k], m[k]) and torch.equal(v2[k], v[k])
    assert int(c2) == 7 and c2.dtype == torch.int32

    ckpt.save(str(tmp_path / "port"), 5, mine, extra={"loader_idx": 20})
    back, step, extra = jckpt.restore(str(tmp_path / "port"), theirs)
    assert step == 5 and extra == {"loader_idx": 20}
    _assert_trees_equal(back, theirs)
    with np.load(tmp_path / "ref" / "step_0000000003" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_0000000005" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)


# ---------------------------------------------------------------------------
# twins of tests/test_system.py's training halves
# ---------------------------------------------------------------------------

def test_paper_pipeline_train_then_ptq():
    """Train a smoke DetNet, quantize it, run INT8 inference (the DSE half
    waits for the port's pricing plane)."""
    cfg = tconfigs.get_smoke("detnet")
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
    res = loop.run_xr_training(net, synthetic.fphab_batches(
        4, cfg.input_hw, cfg.in_channels), loss_fn=xr.circle_loss, steps=5,
        lr=1e-3, hooks=loop.TrainHooks(log_every=0))
    assert res.step == 5 and len(res.losses) == 5
    img = _t(synthetic.fphab_sample(0, 0, cfg.input_hw)["image"])[None]
    outs, _ = ptq.forward_int8(net, img)
    assert bool(torch.isfinite(outs["center"]).all())
    qparams = ptq.quantize_params(dict(net.named_parameters()))
    assert set(qparams) == set(res.params)


def test_checkpoint_restart_resumes_training(tmp_path):
    """Kill-and-restart: a resumed run continues from the checkpoint."""
    cfg = tconfigs.get_smoke("detnet")

    def run(steps):
        net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
        return loop.run_xr_training(
            net, synthetic.fphab_batches(2, cfg.input_hw, cfg.in_channels),
            loss_fn=xr.circle_loss, steps=steps, lr=1e-3,
            ckpt_dir=str(tmp_path), ckpt_every=2,
            hooks=loop.TrainHooks(log_every=0))

    run(4)
    assert ckpt.latest_step(str(tmp_path)) == 4
    res = run(6)
    assert res.step == 6
    assert len(res.losses) == 2          # only steps 4, 5 ran after resume


def test_preemption_checkpoints_and_resumes_bit_exact(tmp_path):
    """SIGTERM mid-run: the loop checkpoints after the step and stops; the
    resumed run (loader skipped to its place) repeats the uninterrupted
    run's remaining losses bit for bit, and the caller's SIGTERM handler
    is back after each run."""
    cfg = tconfigs.get_smoke("detnet")
    before = signal.getsignal(signal.SIGTERM)

    def run(ckpt_dir, kill_at=None):
        net = xr.XRNet(cfg, torch.Generator().manual_seed(1), device="cpu")
        seen = []

        def beat(step, dt):
            if step == kill_at:
                assert signal.getsignal(signal.SIGTERM) is not before
                signal.raise_signal(signal.SIGTERM)

        res = loop.run_xr_training(
            net, synthetic.fphab_batches(2, cfg.input_hw, cfg.in_channels),
            loss_fn=xr.circle_loss, steps=6, lr=1e-3, ckpt_dir=ckpt_dir,
            ckpt_every=100, hooks=loop.TrainHooks(
                heartbeat=beat, on_preempt=seen.append, log_every=0))
        assert signal.getsignal(signal.SIGTERM) is before
        return res, seen

    full, _ = run(str(tmp_path / "a"))
    cut, seen = run(str(tmp_path / "b"), kill_at=2)
    assert seen == [2] and cut.step == 3 and len(cut.losses) == 3
    assert ckpt.latest_step(str(tmp_path / "b")) == 3
    rest, _ = run(str(tmp_path / "b"))
    assert rest.step == 6 and rest.losses == full.losses[3:]


def test_bn_state_is_written_detached():
    """After a step the BN buffers hold the EMA of the batch statistics and
    no graph."""
    cfg = tconfigs.get_smoke("edsnet")
    net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
    img = torch.rand(2, *cfg.input_hw, 1)
    outs, new_state = net(img, train=True)
    assert any(s["mean"].requires_grad for s in new_state.values())
    net.update_bn_state(new_state)
    for name, s in net.bn_state().items():
        assert not s["mean"].requires_grad and s["mean"].grad_fn is None
        assert torch.equal(s["mean"], new_state[name]["mean"].detach())
        assert torch.equal(s["var"], new_state[name]["var"].detach())


def test_train_xr_runs_on_the_cpu(capsys):
    """The entry point, on the smoke DetNet for three steps and the smoke
    EDSNet for two."""
    out = train_xr.main(["--device", "cpu", "--arch", "detnet", "--steps",
                         "3"])
    res, ev = out["result"], out["eval"]
    assert res.step == 3 and len(res.losses) == 3
    assert np.isfinite(res.losses).all()
    assert np.isfinite(ev["fp32"]).all() and np.isfinite(ev["int8"]).all()
    out = train_xr.main(["--device", "cpu", "--arch", "edsnet", "--steps",
                         "2", "--batch", "2"])
    assert 0.0 <= out["eval"]["fp32"] <= 1.0
    assert "held-out mIoU" in capsys.readouterr().out


def test_train_xr_command_refuses_to_run_without_a_card():
    """``python -m repro_torch.launch.train_xr`` without ``--device``
    runs on the card, so on a host without one it fails and trains
    nothing."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train_xr",
                          "--arch", "detnet", "--steps", "3"], cwd=root,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "loss:" not in res.stdout
