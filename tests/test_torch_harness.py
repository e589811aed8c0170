"""repro_torch.calibrate.harness against repro.calibrate.harness: the same
corners, the same analytic counts, the same numpy fit."""
import numpy as np
import pytest

from repro.calibrate import harness as jharness
from repro_torch.calibrate import harness


@pytest.fixture(scope="module")
def samples():
    return harness.run_samples(device="cpu")


@pytest.fixture(scope="module")
def jax_samples():
    return jharness.run_samples(interpret=True)


def test_corners_macs_and_analytic_bytes_match_reference(samples,
                                                         jax_samples):
    key = [(s.kernel, s.precision, s.weight_bits, s.act_bits)
           for s in samples]
    assert key == [(s.kernel, s.precision, s.weight_bits, s.act_bits)
                   for s in jax_samples]
    for s, j in zip(samples, jax_samples):
        assert s.macs == j.macs
        assert s.analytic_bytes == j.analytic_bytes
        assert s.width_pairs == j.width_pairs


def test_cpu_corners_are_exact(samples):
    """On the CPU the kernels' plain versions run on both sides."""
    assert all(s.max_abs_err == 0.0 for s in samples)


def test_analytic_costs(samples):
    by = {(s.kernel, s.precision): s for s in samples}
    mm = by["int8_matmul", "int8"]
    assert mm.flops == 2 * mm.macs + 2 * 128 * 128
    assert mm.bytes_accessed == mm.analytic_bytes
    for prec, nbytes in (("bf16", 2), ("fp32", 4)):
        dw = by["depthwise_conv", prec]
        assert dw.flops == 2 * dw.macs
        # the port reads the unpadded input: no padded copy
        assert dw.bytes_accessed == (2 * 8 * 16 * 128 + 9 * 128) * nbytes
        assert dw.bytes_accessed < dw.analytic_bytes


def test_fit_constants_equal_reference(samples, jax_samples):
    for ss in (samples, jax_samples):
        got = harness.fit_constants(ss)
        want = jharness.fit_constants(ss)
        assert got == want
    constants, residuals = harness.fit_constants(samples)
    assert 0.05 <= constants["delivery_width_frac"] <= 0.95
    assert 0 < constants["mac_mul_share"] < 1
    assert residuals["kernel_max_abs_err"] == 0.0


def test_run_calibration_meta():
    data = harness.run_calibration(device="cpu")
    assert data["meta"]["cost_source"] == "analytic"
    assert data["meta"]["device"] == "cpu"
    assert data["meta"]["seed"] == 20260808
    assert len(data["samples"]) == 4
    assert np.isfinite(list(data["constants"].values())).all()
