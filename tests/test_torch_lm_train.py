"""LM training in repro_torch against repro, on the CPU: ``lm.lm_loss`` and
its gradients against ``jax.value_and_grad`` of the reference's, one
optimizer step lowering the loss of its batch, ``make_lm_step`` against the
reference's over three steps, ``launch.train`` (smoke configs, with a
resume and with gradient compression), checkpoints crossing between the
packages, and a resumed run that is already finished. Llama-3.2-1B and
Mamba-2-1.3B smoke configs; inputs from numpy seeds, parameters drawn by
the reference and carried across (``lm_from_jax``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.params import materialize as jmaterialize
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.launch import train as ltrain
from repro_torch.models import lm
from repro_torch.models.params import (flatten, lm_from_jax, lm_to_jax,
                                       unflatten)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop, optim

ARCHS = ["llama3.2-1b", "mamba2-1.3b"]
B, S = 2, 64           # S: two of the Mamba smoke config's 32-token chunks
# f32 gradients: XLA and PyTorch sum in other orders; held with the
# absolute tolerance tests/test_torch_train.py uses, GRAD_TOL times the
# largest gradient entry over the whole tree. Both are also held in f64:
# the reference evaluated with x64 on and its f32 accumulation type set to
# f64 (`_jax_f64_grads`), the port on f64 parameters (its plain kernels and
# layers compute in the inputs' dtype); the two agree to F64_TOL of the
# largest entry, every leaf. These random nets amplify rounding on the way
# back to the input embedding (the "scaled" init reads the repeat count as
# the fan-in, so each projection gains ~sqrt(d_model/R)): measured against
# the reference's f64 gradient, its own f32 gradient of the tied `embed`
# leaf is 2.5e-4 (Llama) and 1.5e-4 to 3.4e-4 (Mamba) of the largest entry
# off, the port's 3.0e-4 and 2.0e-4 to 4.5e-4; Mamba's `conv_w` 0.9e-4 to
# 2.0e-4 and 1.4e-4 to 3.2e-4. Only the leaves in ILL_CONDITIONED may miss
# the reference's f32 gradient by more than GRAD_TOL, and then the port's
# distance from f64 is at most GRAD_K times the reference's + GRAD_TOL (as
# chip_smoke.py holds the card against the CPU)
GRAD_TOL, GRAD_K, F64_TOL = 1e-4, 2.0, 1e-8
ILL_CONDITIONED = {"embed", "blocks.blk0.ssm.conv_w"}
LOSS_RTOL = 1e-5
# bf16 (the configs' own dtype): both packages round to bf16 where the
# model says, in other sum orders, so the port's bf16 gradient is held to be
# as close to the reference's f32 gradient as the reference's own bf16
# gradient is: its largest distance at most BF16_FACTOR times the
# reference's, + BF16_FLOOR of the largest entry
BF16_FACTOR, BF16_FLOOR = 2.0, 1e-2
# three f32 steps of the two step functions: the losses agree (the
# parameters move by lr-sized AdamW steps of gradients that agree to
# GRAD_TOL; leaves whose gradient is noise get +-lr either way)
STEP_RTOL = 1e-4


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype))


def _trees(jcfg, dtype, seed=0):
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(seed))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    return jp, lm_from_jax(jp)


def _batch(cfg, seed, b=B, s=S, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _jax_grads(jcfg, jp, batch):
    (loss, aux), g = jax.value_and_grad(jlm.lm_loss, has_aux=True,
                                        argnums=1)(
        jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in flatten(g).items()}


def _port_grads(tcfg, tp, batch):
    flat = flatten(tp)
    for p in flat.values():
        p.requires_grad_(True)
    loss, aux = lm.lm_loss(tcfg, tp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    loss.backward()
    assert float(aux["moe_aux"]) == 0.0
    return float(loss.detach()), {k: p.grad.double().numpy()
                                  for k, p in flat.items()}


def _max_err(a, b):
    assert set(a) == set(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _port_f64_grads(arch, jp, batch):
    _, cfg = _cfgs(arch, "float64")
    tp = {k: t.double() for k, t in flatten(lm_from_jax(jp)).items()}
    return _port_grads(cfg, unflatten(tp), batch)


def _jax_f64_grads(arch, jp, batch, monkeypatch):
    """The reference's loss and gradients in f64: x64 on, parameters in
    f64, and the f32 its layers accumulate in (`f32` of both modules) set
    to f64, so that no step of the evaluation rounds to f32."""
    jcfg, _ = _cfgs(arch, "float64")
    monkeypatch.setattr(jlm, "f32", jnp.float64)
    monkeypatch.setattr(jlayers, "f32", jnp.float64)
    with jax.enable_x64(True):
        jp64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                            jp)
        (loss, _), g = jax.value_and_grad(jlm.lm_loss, has_aux=True,
                                          argnums=1)(
            jcfg, jp64, {k: jnp.asarray(v) for k, v in batch.items()})
        g = {k: np.asarray(v) for k, v in flatten(g).items()}
    assert all(v.dtype == np.float64 for v in g.values())
    return float(loss), g


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_gradients_match_jax_value_and_grad(arch, mask,
                                                     monkeypatch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _trees(jcfg, "float32")
    batch = _batch(jcfg, 1, mask=mask)
    lj, gj = _jax_grads(jcfg, jp, batch)
    lt, gt = _port_grads(tcfg, tp, batch)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    gmax = max(float(np.abs(v).max()) for v in gj.values())
    l64, g64 = _jax_f64_grads(arch, jp, batch, monkeypatch)
    lp64, gp64 = _port_f64_grads(arch, jp, batch)
    np.testing.assert_allclose(lp64, l64, rtol=1e-12)
    for k in g64:
        assert float(np.abs(gp64[k] - g64[k]).max()) <= F64_TOL * gmax, k
    for k in gj:
        assert gt[k].shape == gj[k].shape, k
        if float(np.abs(gt[k] - gj[k]).max()) <= GRAD_TOL * gmax:
            continue
        assert k in ILL_CONDITIONED, k
        ref_off = float(np.abs(gj[k] - g64[k]).max())
        port_off = float(np.abs(gt[k] - g64[k]).max())
        assert port_off <= GRAD_K * ref_off + GRAD_TOL * gmax, (k, port_off,
                                                                ref_off)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_as_close_to_f32_as_the_reference(arch):
    jcfg32, _ = _cfgs(arch, "float32")
    jp32, _ = _trees(jcfg32, "float32")
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _trees(jcfg, "bfloat16")
    batch = _batch(jcfg, 2)
    l32, g32 = _jax_grads(jcfg32, jp32, batch)
    lj, gj = _jax_grads(jcfg, jp, batch)
    lt, gt = _port_grads(tcfg, tp, batch)
    gmax = max(float(np.abs(v).max()) for v in g32.values())
    e_ref, e_port = _max_err(gj, g32), _max_err(gt, g32)
    assert e_port <= BF16_FACTOR * e_ref + BF16_FLOOR * gmax, (e_port, e_ref)
    assert abs(lt - l32) <= BF16_FACTOR * abs(lj - l32) + 1e-2 * abs(l32)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_reduces_loss_direction(arch):
    """Twin of tests/test_smoke_archs.py: the smoke config as it is
    (bf16), one clipped AdamW step at lr 1e-3, the same batch again."""
    cfg = tconfigs.get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    step = loop.make_lm_step(cfg, params, lambda s: 1e-3)
    opt = optim.adamw_init(flatten(params))
    opt, m0 = step(opt, batch, 0)
    assert bool(torch.isfinite(m0["loss"]))
    opt, m1 = step(opt, batch, 1)
    assert float(m1["loss"]) < float(m0["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_make_lm_step_matches_reference_over_three_steps(arch):
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp = _trees(jcfg, "float32", seed=3)
    jlr = joptim.cosine_schedule(3e-3, 1, 3)
    tlr = optim.cosine_schedule(3e-3, 1, 3)
    jstep = jloop.make_lm_step(jcfg, jlr)
    tstep = loop.make_lm_step(tcfg, tp, tlr)
    jopt, topt = joptim.adamw_init(jp), optim.adamw_init(flatten(tp))
    jl, tl = [], []
    for i in range(3):
        batch = _batch(jcfg, 10 + i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                             jnp.asarray(i))
        topt, tm = tstep(topt, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, i)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=STEP_RTOL)
    assert int(topt.count) == int(jopt.count) == 3


def test_make_lm_step_refuses_a_parameter_without_gradient():
    cfg = dataclasses.replace(tconfigs.get_smoke("llama3.2-1b"),
                              dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["unused"] = torch.zeros(3)
    step = loop.make_lm_step(cfg, params, lambda s: 1e-3)
    with pytest.raises(RuntimeError, match="no gradient reached.*unused"):
        step(optim.adamw_init(flatten(params)),
             {k: torch.from_numpy(v) for k, v in _batch(cfg, 0, s=32).items()},
             0)


def _args(arch, tmp_path=None, steps=4, *extra):
    a = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", str(steps),
         "--batch", "2", "--seq", "32", *extra]
    if tmp_path is not None:
        a += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    return a


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_and_resumes_on_the_cpu(arch, tmp_path, capsys):
    """Four steps with checkpoints at 2 and 4; the step-4 checkpoint
    removed, a second run resumes at step 2 (the token stream restarted at
    2 x batch) and repeats steps 2-3 bit for bit."""
    first = ltrain.main(_args(arch, tmp_path))
    assert len(first.losses) == 4 and first.step == 4
    assert all(np.isfinite(first.losses))
    assert ckpt.latest_step(str(tmp_path)) == 4
    import shutil
    shutil.rmtree(tmp_path / f"step_{4:010d}")
    again = ltrain.main(_args(arch, tmp_path))
    assert again.start == 2 and again.step == 4
    assert again.losses == first.losses[2:]
    assert "resumed from step 2" in capsys.readouterr().out


def test_train_launcher_with_compressed_gradients(tmp_path):
    plain = ltrain.main(_args("llama3.2-1b", steps=3))
    comp = ltrain.main(_args("llama3.2-1b", None, 3, "--compress-grads"))
    assert len(comp.losses) == 3 and all(np.isfinite(comp.losses))
    assert comp.losses[0] == plain.losses[0]        # before any update
    assert comp.losses != plain.losses


def test_train_launcher_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltrain.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])


def test_resuming_a_finished_run_returns_cleanly(tmp_path):
    """The latest checkpoint already at ``steps``: the LM launcher and
    ``run_xr_training`` return with no steps and no losses (the reference's
    XR loop raises there, src/repro/train/loop.py:137)."""
    first = ltrain.main(_args("llama3.2-1b", tmp_path, steps=2))
    assert first.step == 2
    res = ltrain.main(_args("llama3.2-1b", tmp_path, steps=2))
    assert res.start == 2 and res.step == 2 and res.losses == []
    from repro_torch.launch import train_xr
    from repro_torch.models import xr
    cfg = tconfigs.get_smoke("detnet")
    xdir = tmp_path / "xr"
    for _ in range(2):
        net = xr.XRNet(cfg, torch.Generator().manual_seed(0), device="cpu")
        out = loop.run_xr_training(
            net, train_xr.batches(cfg, 2), loss_fn=xr.circle_loss, steps=2,
            ckpt_dir=str(xdir), ckpt_every=2,
            hooks=loop.TrainHooks(log_every=0))
    assert out.step == 2 and out.losses == []


def _assert_trees_equal(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(b)[0])
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        y = flat_b[path]
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_checkpoints_cross_between_the_packages_bit_exact(arch, tmp_path):
    """The port's launcher writes {"p", "o"} for a smoke config (bf16
    parameters, f32 moments); the reference restores it into its own
    layout bit for bit. The reference's own checkpoint of the same tree
    (bf16 stored as 2-byte voids) restores in the port bit for bit."""
    ltrain.main(_args(arch, tmp_path / "port", steps=2))
    cfg_t = tconfigs.get_smoke(arch)
    params = lm.init_params(cfg_t, torch.Generator().manual_seed(5), "cpu")
    like_t = ltrain.train_tree(params, optim.adamw_init(flatten(params)))
    tree_t, step, extra = ckpt.restore(str(tmp_path / "port"), like_t)
    assert step == 2 and extra["loader_idx"] == 4
    jcfg = jconfigs.get_smoke(arch)
    jp = jmaterialize(jlm.param_defs(jcfg), jax.random.key(0))
    like_j = {"p": jp, "o": joptim.adamw_init(jp)}
    tree_j, step_j, _ = jckpt.restore(str(tmp_path / "port"), like_j)
    assert step_j == 2
    mine = {"p": lm_to_jax(tree_t["p"]),
            "o": joptim.AdamWState(lm_to_jax(tree_t["o"]["m"]),
                                   lm_to_jax(tree_t["o"]["v"]),
                                   np.asarray(tree_t["o"]["count"]))}
    _assert_trees_equal(tree_j, mine)
    assert int(tree_j["o"].count) == 2
    # the other way round: the reference writes, the port restores
    jckpt.save(str(tmp_path / "ref"), 7, tree_j, extra={"loader_idx": 14})
    back, step, extra = ckpt.restore(str(tmp_path / "ref"), like_t)
    assert step == 7 and extra == {"loader_idx": 14}
    for k, t in flatten(back["p"]).items():
        assert t.dtype == flatten(tree_t["p"])[k].dtype
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, flatten(tree_t["p"])[k].view(torch.int16)
                           if t.dtype == torch.bfloat16
                           else flatten(tree_t["p"])[k]), k
    for part in ("m", "v"):
        for k, t in flatten(back["o"][part]).items():
            assert torch.equal(t, flatten(tree_t["o"][part])[k]), k
    assert int(back["o"]["count"]) == 2
