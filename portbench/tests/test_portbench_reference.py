"""The plain reference held to the port's CPU path on the smoke configs:
the plan, the train-mode forward and BN state, both losses, every
gradient, three steps of the training entry, the schedule and the AdamW
update, and INT8 evaluation. The
test imports both; the reference imports neither the port nor JAX."""
import signal

import pytest
import torch

from conftest import smoke_config

ARCHS = ("detnet", "edsnet")
SEED = 2 ** 31 + 977


def close(got, want, rtol=1e-5):
    """Within ``rtol`` of the larger of the reference's largest entry."""
    scale = max(float(want.abs().max()), 1e-12)
    return float((got - want).abs().max()) <= rtol * scale


def bn_close(got, want, rtol=1e-5):
    """BN state leaf by leaf: a mean within ``rtol`` of its layer's
    standard deviation (many means are nought to rounding), a variance
    within ``rtol`` of itself."""
    for k, v in want.items():
        step, leaf = k.split(".")
        scale = want[f"{step}.var"].sqrt() if leaf == "mean" else v
        assert bool(((got[k] - v).abs() <= rtol * scale + 1e-12).all()), k


def setup(arch, batch=8):
    from portbench.inputs import xr as inputs
    from portbench.drivers.xr_common import program_config
    from repro_torch.models import xr
    cfg = smoke_config(arch)
    w = inputs.weights(cfg, SEED, "cpu")
    b = inputs.batches(cfg, SEED, 0, 1, batch, "cpu")[0]
    net = xr.XRNet(program_config(cfg), torch.Generator().manual_seed(0),
                   device="cpu")
    net.load_state_dict(w)
    return cfg, w, b, net


@pytest.mark.parametrize("arch", ARCHS + ("full-detnet", "full-edsnet"))
def test_plan_and_leaves_are_the_ports(arch):
    import json

    from conftest import ROOT
    from portbench.drivers.xr_common import program_config
    from portbench.reference import xr as ref
    from repro_torch.models import xr
    if arch.startswith("full-"):
        cfg = json.loads((ROOT / "portbench" / "configs"
                          / f"{arch[5:]}.json").read_text())
    else:
        cfg = smoke_config(arch)
    pc = program_config(cfg)
    mine = [(s.name, s.op, s.out_ch, s.kernel, s.stride, s.relu, s.bn, s.src,
             s.skip, s.save_as) for s in ref.build_plan(cfg)]
    port = [(s.name, s.op, s.out_ch, s.kernel, s.stride, s.relu, s.bn, s.src,
             s.skip, s.save_as) for s in xr.build_plan(pc)]
    assert mine == port
    defs = xr.param_defs(pc)
    shapes = {f"{step}.{leaf}": d.shape for tree in defs
              for step, leaves in tree.items() for leaf, d in leaves.items()}
    mine = ref.leaf_shapes(cfg)
    assert set(mine) == set(shapes)
    for k, (shape, kind) in mine.items():
        # the port's layouts: OIHW convs and (out, in) dense from the
        # JAX package's HWIO and (in, out)
        want = shapes[k]
        if kind in ("conv", "dwconv"):
            want = (want[3], want[2], want[0], want[1])
        elif kind == "dense_w":
            want = (want[1], want[0])
        assert shape == want, k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_gradients(arch):
    from portbench.reference import xr as ref
    from repro_torch.models import xr
    cfg, w, batch, net = setup(arch)
    outs, new_state = net(batch["image"], train=True)
    loss_fn = xr.circle_loss if arch == "detnet" else xr.dice_loss
    loss, _ = loss_fn(outs, batch)
    loss.backward()
    p, s = ref.split(w)
    rp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    r_outs, r_state = ref.forward(cfg, rp, s, batch["image"], train=True)
    r_loss = ref.LOSSES[cfg["task"]](r_outs, batch)
    grads = dict(zip(rp, torch.autograd.grad(r_loss, list(rp.values()))))
    for head in r_outs:
        assert close(outs[head].detach(), r_outs[head].detach()), head
    bn_close({f"{st}.{leaf}": t.detach() for st, d in new_state.items()
              for leaf, t in d.items()}, {k: v.detach() for k, v in r_state.items()})
    assert abs(float(loss.detach()) - float(r_loss.detach())) \
        <= 1e-5 * abs(float(r_loss.detach()))
    gmax = max(float(g.abs().max()) for g in grads.values())
    for k, prm in net.named_parameters():
        err = float((prm.grad - grads[k]).abs().max())
        assert err <= 1e-4 * gmax, (k, err, gmax)


@pytest.mark.parametrize("arch", ARCHS)
def test_losses_on_random_outputs(arch):
    from portbench.reference import xr as ref
    from repro_torch.models import xr
    g = torch.Generator().manual_seed(3)
    if arch == "detnet":
        outs = {"center": torch.randn(6, 4, generator=g),
                "radius": torch.randn(6, 2, generator=g),
                "label": torch.randn(6, 2, generator=g)}
        batch = {"center": torch.rand(6, 2, 2, generator=g),
                 "radius": torch.rand(6, 2, generator=g),
                 "label": torch.randint(0, 2, (6,), generator=g).int()}
        want = xr.circle_loss(outs, batch)[0]
        got = ref.circle_loss(outs, batch)
    else:
        outs = {"mask": torch.randn(3, 5, 7, 4, generator=g)}
        batch = {"mask": torch.randint(0, 4, (3, 5, 7), generator=g).int()}
        want = xr.dice_loss(outs, batch)[0]
        got = ref.dice_loss(outs, batch)
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_of_the_training_entry(arch):
    """``run_xr_training`` as the benchmark drives it (a step count no run
    reaches, stopped by SIGTERM) against ``train_steps``: each loss, the
    parameters and the BN state after three steps."""
    from portbench.drivers import xr_train
    from portbench.lib.outcome import leaf_gap
    from portbench.reference import xr as ref
    from repro_torch.models import xr
    from repro_torch.train import loop
    cfg, w, _, net = setup(arch)
    from portbench.inputs import xr as inputs
    pool = [inputs.to_host(b) for b in inputs.batches(cfg, SEED, 0, 3, 8, "cpu")]

    def beat(step, dt):
        if step == 2:
            signal.raise_signal(signal.SIGTERM)

    res = loop.run_xr_training(
        net, iter([(b, i + 1) for i, b in enumerate(pool)]),
        loss_fn=getattr(xr, xr_train.LOSSES[cfg["task"]]), steps=xr_train.STEPS,
        lr=xr_train.BASE_LR, hooks=loop.TrainHooks(heartbeat=beat, log_every=0))
    assert res.step == 3
    p, s = ref.split(w)
    lrs = [ref.warmup_lr(xr_train.BASE_LR, t, xr_train.WARMUP) for t in range(3)]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in pool]
    losses, first, r_p, r_s = ref.train_steps(cfg, p, s, batches, lrs)
    for a, b in zip(res.losses, losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    sd = net.state_dict()
    # the change of each leaf by its norm, the leaves whose gradient is
    # nought to rounding left out (AdamW moves them by +-lr on noise), as
    # the benchmark's check measures it
    gnorm = {k: float(g.norm()) for k, g in first.items()}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in r_p if gnorm[k] >= xr_train.NOUGHT * med]
    gap, leaf = leaf_gap({k: sd[k] - p[k] for k in moved},
                         {k: r_p[k] - p[k] for k in moved}, moved)
    assert gap <= 1e-2, leaf
    bn_close(sd, r_s)


@pytest.mark.parametrize("step", [0, 1, 49, 50, 51, 977])
def test_schedule_and_adamw_update(step):
    """The rate at each step as the entry's schedule gives it, and one
    AdamW step from given moments, clip and decay included, as the port's
    ``clip_by_global_norm`` and ``adamw_update`` take it."""
    from portbench.drivers import xr_train
    from portbench.reference import xr as ref
    from repro_torch.train import optim
    lr_fn = optim.cosine_schedule(xr_train.BASE_LR, xr_train.WARMUP,
                                  xr_train.STEPS)
    lr = ref.schedule_lr(xr_train.BASE_LR, step, xr_train.WARMUP,
                         xr_train.STEPS)
    assert lr == float(lr_fn(step))
    g = torch.Generator().manual_seed(step)
    shapes = {"a": (5, 3), "b": (7,)}
    p = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = {k: 3 * torch.randn(s, generator=g) for k, s in shapes.items()}
    m = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    v = {k: torch.rand(s, generator=g) for k, s in shapes.items()}
    count = torch.tensor(step, dtype=torch.int32)
    clipped, norm = optim.clip_by_global_norm(grads, 1.0)
    new_p, st = optim.adamw_update(clipped, optim.AdamWState(m, v, count), p,
                                   lr=max(lr, 1e-3))
    assert float(norm) > 1.0
    for k in p:
        want = ref.adamw_apply(p[k], st.m[k], st.v[k], step + 1, max(lr, 1e-3))
        assert close(new_p[k] - p[k], want - p[k], 1e-5), k


@pytest.mark.parametrize("arch", ARCHS)
def test_first_gradient_is_the_clipped_one(arch):
    """``train_steps``' first gradient is the one AdamW gets: clipped to a
    global norm of at most 1, and unchanged where the norm is under it."""
    from portbench.reference import xr as ref
    cfg, w, batch, _ = setup(arch)
    p, s = ref.split(w)
    _, first, _, _ = ref.train_steps(cfg, p, s, [batch], [0.0])
    _, raw, _, _ = ref.train_steps(cfg, p, s, [batch], [0.0], max_norm=1e30)
    raw_norm = float(torch.sqrt(sum((t.double() ** 2).sum()
                                    for t in raw.values())))
    scale = min(1.0, 1.0 / raw_norm)
    for k in p:
        assert close(first[k], raw[k] * scale, 1e-6), k


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_evaluation(arch):
    """Weight fake-quant bit for bit, BN statistics from a batch, and the
    eval-mode forward of the quantized net."""
    from portbench.reference import xr as ref
    from repro_torch.quant import ptq
    cfg, w, batch, net = setup(arch)
    p, s = ref.split(w)
    qp = ref.quantize_weights(p, 8)
    port_q = ptq.quantize_params(dict(net.named_parameters()))
    for k, v in qp.items():
        assert torch.equal(port_q[k].detach(), v), k
    net.set_bn_stats(batch["image"])
    state = ref.bn_stats(cfg, p, s, batch["image"])
    bn_close(net.state_dict(), state)
    got, _ = ptq.forward_int8(net, batch["image"])
    want = ref.int8_forward(cfg, qp, state, batch["image"])
    for head in want:
        assert close(got[head], want[head], 1e-4), head
