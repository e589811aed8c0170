"""repro_torch.quant.ptq and repro_torch.data against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.models import xr as jxr
from repro.quant import ptq as jptq
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsyn
from repro_torch.models import xr
from repro_torch.models.params import from_jax, to_jax
from repro_torch.quant import ptq

# Activation fake-quant parity. XLA and oneDNN sum convolutions in different
# orders (~1e-6 relative), so a value within that distance of a rounding
# boundary (k + 0.5 steps) can take the neighbouring code. With random
# weights one flipped code then cascades: each later layer amplifies it
# (measured on full-width DetNet: one flip in irb3_dw, tens of steps at the
# heads), so no output tolerance in act steps holds a priori. The tests
# compare codes layer by layer instead: up to the first layer whose codes
# differ, all codes are equal; in that layer (its inputs still equal) every
# differing code is a near-tie, within TIE of k + 0.5 steps, and they are
# rare (at most FLIP_FRAC of the layer's codes).
TIE = 1e-3
FLIP_FRAC = 1e-3


def _np_tree(defs, seed):
    """Reference-layout tree drawn with numpy under the reference's init
    rules (zeros / ones / normal with std scale/sqrt(shape[0]))."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(defs):
        out[k] = {}
        for leaf in sorted(defs[k]):
            d = defs[k][leaf]
            if d.init in ("zeros", "ones"):
                out[k][leaf] = np.full(d.shape, d.init == "ones", np.float32)
            else:
                out[k][leaf] = (rng.standard_normal(d.shape) * d.scale
                                / np.sqrt(d.shape[0])).astype(np.float32)
    return out


def _setup(name, full, batch=2):
    jcfg = jconfigs.get_config(name) if full else jconfigs.get_smoke(name)
    tcfg = tconfigs.get_config(name) if full else tconfigs.get_smoke(name)
    pdefs, sdefs = jxr.param_defs(jcfg)
    params, state = _np_tree(pdefs, 0), _np_tree(sdefs, 1)
    img = np.random.default_rng(11).random(
        (batch, *jcfg.input_hw, jcfg.in_channels), dtype=np.float32)
    net = xr.XRNet(tcfg, device="cpu")
    net.load_state_dict(from_jax(params, state))
    net.set_bn_stats(torch.from_numpy(img))   # see XRNet.set_bn_stats
    _, state = to_jax(net.state_dict())
    return jcfg, net, params, state, img


# ---------------------------------------------------------------------------
# codes and scales
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tensor_codes_equal(rng, bits):
    w = (rng.normal(size=(3, 3, 16, 24)) * rng.uniform(0.01, 2.0, (24,))
         ).astype(np.float32)
    jq, js = jptq.quantize_tensor(jnp.asarray(w), axis=-1, bits=bits)
    # the port keeps the output channel on axis 0 (OIHW)
    tq, ts = ptq.quantize_tensor(torch.from_numpy(w.transpose(3, 2, 0, 1)
                                                  .copy()), axis=0, bits=bits)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    m = rng.normal(size=(40, 7)).astype(np.float32)
    for axis in (0, 1, -1):
        jq, js = jptq.quantize_tensor(jnp.asarray(m), axis=axis, bits=bits)
        tq, ts = ptq.quantize_tensor(torch.from_numpy(m), axis=axis, bits=bits)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ptq.code_bits(tq) == jptq.code_bits(np.asarray(jq)) <= bits


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_equal(bits):
    jcfg = jconfigs.get_config("detnet")
    params = _np_tree(jxr.param_defs(jcfg)[0], 5)
    want = from_jax(jax_tree_numpy(jptq.quantize_params(params, bits=bits)),
                    {})
    got = ptq.quantize_params(from_jax(params, {}), bits=bits)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


def jax_tree_numpy(tree):
    return {k: {leaf: np.asarray(v) for leaf, v in sub.items()}
            for k, sub in tree.items()}


def test_minmax_and_fake_quant_equal(rng):
    x = rng.normal(size=(64, 32)).astype(np.float32)
    for axis in (None, 0, 1):
        js = jptq.minmax_scale(jnp.asarray(x), axis=axis)
        ts = ptq.minmax_scale(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jf = jptq.fake_quant(jnp.asarray(x), js, axis=axis)
        tf = ptq.fake_quant(torch.from_numpy(x), ts, axis=axis)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(
        ptq.fake_quant(torch.from_numpy(x), 0.01).numpy(),
        np.asarray(jptq.fake_quant(jnp.asarray(x), 0.01)))
    assert [ptq.qmax(b) for b in (2, 4, 8)] == [jptq.qmax(b) for b in (2, 4, 8)]


@pytest.mark.parametrize("pct", [99.9, 50.0, 90.0, 100.0, 0.0])
def test_percentile_scale_matches_jnp_percentile(rng, pct):
    x = rng.normal(size=(3, 17, 29)).astype(np.float32)
    js = jptq.percentile_scale(jnp.asarray(x), pct)
    ts = ptq.percentile_scale(torch.from_numpy(x), pct)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_percentile_scale_above_2_pow_24_elements():
    """torch.quantile refuses inputs above 2^24 elements; full-width EDSNet
    taps reach 3.9 M elements per image, so calibration at batch 5 passes
    that size. The kthvalue form takes it."""
    n = 2 ** 24 + 5
    x = np.random.default_rng(3).standard_normal(n, dtype=np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x).abs(), 0.999)
    js = jptq.percentile_scale(jnp.asarray(x), 99.9)
    ts = ptq.percentile_scale(torch.from_numpy(x), 99.9)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("pct", [99.9, None])
def test_calibrate_acts_same_activations(rng, pct):
    """The same activations give the same scales (see rtol below)."""
    acts = [{"a": rng.normal(size=(2, 9, 11, 5)).astype(np.float32) * 3,
             "b": rng.random((2, 64)).astype(np.float32)} for _ in range(3)]
    js = jptq.calibrate_acts(lambda b: {k: jnp.asarray(v)
                                        for k, v in b.items()}, acts, pct=pct)
    ts = ptq.calibrate_acts(lambda b: {k: torch.from_numpy(v)
                                       for k, v in b.items()}, acts, pct=pct)
    assert set(ts) == set(js)
    # rtol 1e-5: XLA compiles jnp.percentile's position q * (n - 1) and its
    # interpolation with its own rewrites; the result moves by about one f32
    # ulp of the position times the gap between the two order statistics
    # (measured 2.1e-6 relative here, where n ~ 1000 leaves wide gaps)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5)


@pytest.mark.parametrize("name,full", [("detnet", False), ("edsnet", False),
                                       ("detnet", True)])
def test_calibrate_acts_through_the_nets(name, full):
    """Scales of the two nets' own taps: equal within the forward parity
    (rtol 1e-4; the activations differ by float summation order)."""
    jcfg, net, params, state, img = _setup(name, full, 1 if full else 2)
    js = jptq.calibrate_acts(
        lambda b: jxr.forward(jcfg, params, state, jnp.asarray(b),
                              collect_acts=True)[0]["acts"], [img])

    def tfwd(b):
        with torch.no_grad():
            return net(torch.from_numpy(b), collect_acts=True)[0]["acts"]

    ts = ptq.calibrate_acts(tfwd, [img])
    assert list(ts) == list(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# INT8 inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,full", [("detnet", False), ("edsnet", False),
                                       ("detnet", True)])
@pytest.mark.parametrize("bits", [8, 4])
def test_forward_int8_weights_only(name, full, bits):
    jcfg, net, params, state, img = _setup(name, full, 1 if full else 2)
    jouts, _ = jptq.forward_int8(jcfg, params, state, jnp.asarray(img),
                                 bits=bits)
    touts, _ = ptq.forward_int8(net, torch.from_numpy(img), bits=bits)
    assert set(touts) == set(jouts)
    for k in jouts:
        want = np.asarray(jouts[k])
        scale = max(1.0, float(np.max(np.abs(want))))
        np.testing.assert_allclose(touts[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def assert_codes_agree_to_first_near_tie(acts_a, acts_b, scales, bits=8):
    """See TIE above. Returns the first layer whose codes differ (or None)."""
    qm = jptq.qmax(bits)
    assert list(acts_a) == list(acts_b)
    for name in acts_a:
        ya, yb = np.asarray(acts_a[name]), np.asarray(acts_b[name])
        if name not in scales:
            continue
        ra, rb = ya / scales[name], yb / scales[name]
        ca, cb = np.clip(np.round(ra), -qm, qm), np.clip(np.round(rb), -qm, qm)
        flips = ca != cb
        if flips.any():
            frac = np.abs(np.abs(ra[flips] - np.floor(ra[flips])) - 0.5)
            assert np.all(frac < TIE), (name, float(frac.max()))
            assert flips.mean() <= FLIP_FRAC, (name, int(flips.sum()))
            return name
    return None


@pytest.mark.parametrize("name,full", [("detnet", False), ("edsnet", False),
                                       ("detnet", True)])
def test_forward_int8_with_act_scales(name, full):
    jcfg, net, params, state, img = _setup(name, full, 1 if full else 2)
    scales = jptq.calibrate_acts(
        lambda b: jxr.forward(jcfg, params, state, jnp.asarray(b),
                              collect_acts=True)[0]["acts"], [img])
    jouts, _ = jxr.forward(jcfg, jptq.quantize_params(params), state,
                           jnp.asarray(img), act_scales=scales,
                           collect_acts=True)
    touts, _ = ptq.forward_int8(net, torch.from_numpy(img),
                                act_scales=scales)
    qnet = xr.XRNet(net.cfg, device="cpu")
    qnet.load_state_dict({**net.state_dict(),
                          **ptq.quantize_params(dict(net.named_parameters()))})
    with torch.no_grad():
        qouts, _ = qnet(torch.from_numpy(img), act_scales=scales,
                        collect_acts=True)
    for k in touts:                  # forward_int8 is that quantized net
        assert torch.equal(touts[k], qouts[k])
    first = assert_codes_agree_to_first_near_tie(jouts["acts"], qouts["acts"],
                                                 scales)
    if first is None:                # no near-tie met: codes equal throughout
        for k in touts:
            np.testing.assert_array_equal(touts[k].numpy(),
                                          np.asarray(jouts[k]))


def test_weight_histogram_equal():
    jcfg = jconfigs.get_smoke("detnet")
    params = _np_tree(jxr.param_defs(jcfg)[0], 2)
    jh, je = jptq.weight_histogram(params)
    th, te = ptq.weight_histogram(from_jax(params, {}))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(te, je)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def test_synthetic_arrays_equal():
    for idx in (0, 5):
        a = jsyn.fphab_sample(3, idx, (32, 48), 3)
        b = tsyn.fphab_sample(3, idx, (32, 48), 3)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
        a = jsyn.openeds_sample(3, idx, (24, 40))
        b = tsyn.openeds_sample(3, idx, (24, 40))
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    (ja, jn), (ta, tn) = (next(jsyn.fphab_batches(3, (16, 16), seed=2)),
                          next(tsyn.fphab_batches(3, (16, 16), seed=2)))
    assert jn == tn
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])
    (ja, jn), (ta, tn) = (next(jsyn.openeds_batches(2, (16, 32), seed=1,
                                                    start_idx=4)),
                          next(tsyn.openeds_batches(2, (16, 32), seed=1,
                                                    start_idx=4)))
    assert jn == tn
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k])
