"""repro_torch.models.xr against repro.models.xr on converted parameters:
the plan's layer specs, the parameter bridge and the forward pass."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xr as jxr
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import xr
from repro_torch.models.params import from_jax, to_jax

# Forward parity: fp32 convolutions summed in another order by XLA and by
# oneDNN; ~50 layers deep that stays within a few 1e-6 relative. rtol 1e-4
# and atol 1e-5 scaled by max(1, max|ref|) of the tensor: a float sum's
# rounding error follows the size of its terms, not of the result, so an
# EDSNet logit that cancels to ~0 carries the error of its O(max|out|)
# terms (measured: 4e-5 on logits of max 21).
RTOL, ATOL = 1e-4, 1e-5


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)

CFGS = [("detnet", False), ("edsnet", False), ("detnet", True),
        ("edsnet", True)]


def _cfgs(name, full):
    if full:
        return jconfigs.get_config(name), tconfigs.get_config(name)
    return jconfigs.get_smoke(name), tconfigs.get_smoke(name)


def _jax_tree(defs, seed):
    """A reference parameter tree drawn with numpy under the reference's
    init rules (repro.models.params.materialize), without paying JAX's
    per-shape compiles of jax.random."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(defs):
        out[k] = {}
        for leaf in sorted(defs[k]):
            d = defs[k][leaf]
            if d.init in ("zeros", "ones"):
                a = np.full(d.shape, d.init == "ones", np.float32)
            else:
                std = d.scale / np.sqrt(d.shape[0])
                a = (rng.standard_normal(d.shape) * std).astype(np.float32)
            out[k][leaf] = a
    return out


def _setup(name, full, batch=2):
    """Reference params + a port net carrying them, BN state set to the
    batch statistics of the images (see XRNet.set_bn_stats), and the
    reference's trees with that same state."""
    jcfg, tcfg = _cfgs(name, full)
    pdefs, sdefs = jxr.param_defs(jcfg)
    params, state = _jax_tree(pdefs, 0), _jax_tree(sdefs, 1)
    img = np.random.default_rng(7).random(
        (batch, *jcfg.input_hw, jcfg.in_channels), dtype=np.float32)
    net = xr.XRNet(tcfg, device="cpu")
    net.load_state_dict(from_jax(params, state))
    net.set_bn_stats(torch.from_numpy(img))
    _, state = to_jax(net.state_dict())
    return jcfg, net, params, state, img


@pytest.mark.parametrize("name,full", CFGS)
def test_conv_layer_specs_equal_field_by_field(name, full):
    jcfg, tcfg = _cfgs(name, full)
    want = [dataclasses.asdict(s) for s in jxr.conv_layer_specs(jcfg)]
    got = [dataclasses.asdict(s) for s in xr.conv_layer_specs(tcfg)]
    assert got == want
    assert [s.macs for s in xr.conv_layer_specs(tcfg)] == \
        [s.macs for s in jxr.conv_layer_specs(jcfg)]


@pytest.mark.parametrize("name,full", CFGS)
def test_configs_and_plan_equal(name, full):
    jcfg, tcfg = _cfgs(name, full)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.asdict(s) for s in xr.build_plan(tcfg)] == \
        [dataclasses.asdict(s) for s in jxr.build_plan(jcfg)]
    jp, js = jxr.param_defs(jcfg)
    tp, ts = xr.param_defs(tcfg)
    for jt, tt in ((jp, tp), (js, ts)):
        assert {k: {leaf: dataclasses.asdict(d) for leaf, d in v.items()}
                for k, v in jt.items()} == \
            {k: {leaf: dataclasses.asdict(d) for leaf, d in v.items()}
             for k, v in tt.items()}


@pytest.mark.parametrize("name", ["detnet", "edsnet"])
def test_stride1_depthwise_steps_are_the_kernel_steps(name):
    """13 stride-1 3x3 depthwise steps per full-width forward run the
    depthwise kernel; the stride-2 ones stay on F.conv2d."""
    plan = xr.build_plan(tconfigs.get_config(name))
    assert sum(xr.uses_depthwise_kernel(st) for st in plan) == 13
    assert sum(st.op == "dwconv" for st in plan) == 17


@pytest.mark.parametrize("name,full", CFGS)
def test_from_jax_to_jax_round_trip_is_exact(name, full):
    jcfg, tcfg = _cfgs(name, full)
    pdefs, sdefs = jxr.param_defs(jcfg)
    params, state = _jax_tree(pdefs, 3), _jax_tree(sdefs, 4)
    sd = from_jax(params, state)
    assert set(sd) == {f"{k}.{leaf}" for tree in (params, state)
                       for k, v in tree.items() for leaf in v}
    net = xr.XRNet(tcfg, device="cpu")
    net.load_state_dict(sd)          # strict: same keys, shapes fit
    p2, s2 = to_jax(net.state_dict())
    for want, got in ((params, p2), (state, s2)):
        assert set(got) == set(want)
        for k in want:
            assert set(got[k]) == set(want[k])
            for leaf in want[k]:
                assert got[k][leaf].shape == want[k][leaf].shape
                np.testing.assert_array_equal(got[k][leaf], want[k][leaf])


def test_port_layout_of_converted_weights():
    jcfg, tcfg = _cfgs("detnet", False)
    params = _jax_tree(jxr.param_defs(jcfg)[0], 0)
    sd = from_jax(params, {})
    w = params["irb1_dw"]["w"]                     # (3,3,1,C)
    np.testing.assert_array_equal(sd["irb1_dw.w"].numpy()[:, 0],
                                  w[:, :, 0, :].transpose(2, 0, 1))
    np.testing.assert_array_equal(sd["stem.w"].numpy(),
                                  params["stem"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["center_fc1.w"].numpy(),
                                  params["center_fc1"]["w"].T)


def test_materialize_follows_reference_init():
    """Same shapes and init rules: zeros/ones exact, scaled draws with std
    scale/sqrt(shape[0]) of the reference layout."""
    from repro_torch.models.params import materialize
    pdefs, sdefs = xr.param_defs(tconfigs.get_config("detnet"))
    p = materialize(pdefs, torch.Generator().manual_seed(0), "cpu")
    p2 = materialize(pdefs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["head_conv"]["w"], p2["head_conv"]["w"])
    assert sum(t.numel() for v in p.values() for t in v.values()) == \
        2_470_344
    w = p["head_conv"]["w"]                        # (1,1,320,1280): std 1
    assert abs(float(w.std()) - 1.0) < 0.01
    assert torch.all(p["stem"]["bn_scale"] == 1)
    s = materialize(sdefs, torch.Generator().manual_seed(0), "cpu")
    assert torch.all(s["stem"]["var"] == 1) and torch.all(s["stem"]["mean"] == 0)


def _assert_outputs_close(jouts, touts):
    assert set(touts) == set(jouts)
    for k in jouts:
        assert tuple(touts[k].shape) == jouts[k].shape
        assert_close(touts[k].numpy(), jouts[k], err_msg=k)


@pytest.mark.parametrize("name,full", CFGS[:3])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_reference(name, full, train):
    jcfg, net, params, state, img = _setup(name, full, batch=1 if full else 2)
    jouts, jstate = jxr.forward(jcfg, params, state, jnp.asarray(img),
                                train=train)
    with torch.no_grad():
        touts, tstate = net(torch.from_numpy(img), train=train)
    _assert_outputs_close(jouts, touts)
    assert set(tstate) == set(jstate)
    for k in jstate:
        for leaf in ("mean", "var"):
            assert_close(tstate[k][leaf].numpy(), jstate[k][leaf],
                         err_msg=f"{k}.{leaf}")


def test_collect_acts_keys_match_reference():
    jcfg, net, params, state, img = _setup("edsnet", False)
    jouts, _ = jxr.forward(jcfg, params, state, jnp.asarray(img),
                           collect_acts=True)
    with torch.no_grad():
        touts, _ = net(torch.from_numpy(img), collect_acts=True)
    assert list(touts["acts"]) == list(jouts["acts"])
    _assert_outputs_close(jouts["acts"], touts["acts"])


def test_forward_keeps_channels_last_into_the_depthwise_kernel(monkeypatch):
    """Every stride-1 depthwise step hands the kernel a contiguous NHWC view
    of the running activation (no copy), and runs once per step."""
    calls = []
    real = ops.depthwise_conv3x3

    def spy(x, w):
        calls.append(x.is_contiguous())
        return real(x, w)

    monkeypatch.setattr(ops, "depthwise_conv3x3", spy)
    net = xr.XRNet(tconfigs.get_smoke("edsnet"), device="cpu")
    img = torch.rand(1, 32, 64, 1)
    with torch.no_grad():
        net(img)
    n = sum(xr.uses_depthwise_kernel(st) for st in net.plan)
    assert len(calls) == n > 0 and all(calls)
