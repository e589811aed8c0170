"""repro_torch.core (the pricing plane) against repro.core, byte for byte,
and the port's calibration gate against the reference's."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.calibrate import harness as jharness
from repro.core import columns as jcolumns
from repro.core import dse as jdse
from repro.core import experiment as jxp
from repro.core import nvm as jnvm
from repro_torch.calibrate import harness
from repro_torch.configs import get_config
from repro_torch.core import columns, dse, nvm
from repro_torch.core import experiment as xp
from repro_torch.models import xr

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = ["fig2f", "fig3d", "fig4", "fig5", "table2", "table3", "lm_kv",
          "quant", "placement", "system"]


def test_the_port_has_the_reference_sweeps_but_the_trace_plane():
    assert list(xp.SWEEPS) == SWEEPS
    assert set(jxp.SWEEPS) - set(xp.SWEEPS) == {"trace"}


def test_the_core_modules_are_the_reference_ones_but_roofline():
    names = {p.stem for p in (ROOT / "src" / "repro_torch" / "core")
             .glob("*.py")}
    want = {p.stem for p in (ROOT / "src" / "repro" / "core").glob("*.py")}
    assert names == want - {"roofline"}


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_rows_equal_the_reference(name):
    got = json.dumps(xp.SWEEPS[name].rows(xp.Evaluator()), sort_keys=True)
    want = json.dumps(jxp.SWEEPS[name].rows(jxp.Evaluator()), sort_keys=True)
    assert got == want


def _arrays(obj):
    """Every numpy column of a table, by field and property name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[f.name] = v
    for name in dir(type(obj)):
        if isinstance(getattr(type(obj), name), property):
            v = getattr(obj, name)
            if isinstance(v, np.ndarray):
                out[name] = v
    return out


def _assert_tables_equal(got, want):
    a, b = _arrays(got), _arrays(want)
    assert a.keys() == b.keys() and a
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=a[k].dtype.kind == "f"), k


@pytest.mark.parametrize("space", ["fig5_space", "fig3d_space",
                                   "placement_space"])
def test_columnar_tables_equal_the_reference(space):
    ev, jev = xp.Evaluator(), jxp.Evaluator()
    pts, jpts = list(getattr(xp, space)()), list(getattr(jxp, space)())
    tab, jtab = ev.evaluate_table(pts), jev.evaluate_table(jpts)
    _assert_tables_equal(tab, jtab)
    grid = np.geomspace(0.01, 100.0, 9)
    _assert_tables_equal(ev.power_curves(pts, grid),
                         jev.power_curves(jpts, grid))
    _assert_tables_equal(ev.area_table(pts), jev.area_table(jpts))
    nvm_rows, sram_rows = nvm.sram_pairs(pts)
    assert (nvm_rows, sram_rows) == jnvm.sram_pairs(jpts)
    got = columns.crossover_ips(tab, nvm_rows, sram_rows)
    want = jcolumns.crossover_ips(jtab, nvm_rows, sram_rows)
    assert np.array_equal(got, want, equal_nan=True)


SHIMS = [("suite_sizes", {}), ("sweep_fig2f", {}), ("sweep_fig3d", {}),
         ("sweep_fig5", {"n_points": 7}), ("table2_area", {}),
         ("table3_ips", {}), ("fig4_breakdown", {}), ("lm_kv_dse", {}),
         ("sweep_quant", {}), ("sweep_placement", {}), ("sweep_system", {})]


@pytest.mark.parametrize("name,kw", SHIMS, ids=[s[0] for s in SHIMS])
def test_dse_shims_equal_the_reference(name, kw):
    got = json.dumps(getattr(dse, name)(**kw), sort_keys=True)
    want = json.dumps(getattr(jdse, name)(**kw), sort_keys=True)
    assert got == want


@pytest.mark.parametrize("variant,device", [("sram", None), ("p0", None),
                                            ("p1", None), ("p1", "stt")])
@pytest.mark.parametrize("arch", ["simba", "eyeriss", "cpu"])
def test_evaluate_on_the_ports_specs_equals_the_reference(arch, variant,
                                                          device):
    """``dse.evaluate`` and ``evaluate_area`` of a list of the port's own
    ``ConvLayerSpec``s against the reference on its model's specs."""
    from repro import configs as jconfigs
    from repro.models import xr as jxr
    for name in ("detnet", "edsnet"):
        specs = xr.conv_layer_specs(get_config(name))
        jspecs = jxr.conv_layer_specs(jconfigs.get_config(name))
        for fn, jfn in ((dse.evaluate, jdse.evaluate),
                        (dse.evaluate_area, jdse.evaluate_area)):
            got = fn(specs, arch, 7, variant, device)
            want = jfn(jspecs, arch, 7, variant, device)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_calibrated_json_is_the_references_bytes():
    port = ROOT / "src" / "repro_torch" / "calibrate" / "calibrated.json"
    ref = ROOT / "src" / "repro" / "calibrate" / "calibrated.json"
    assert port.read_bytes() == ref.read_bytes()
    from repro.core import devices as jdev
    from repro_torch.core import devices
    assert devices.CALIBRATED == jdev.CALIBRATED


def test_the_refit_names_the_card_and_passes_its_own_gate():
    """The committed refit was written on the card; a CPU re-run (the
    kernels' plain versions, the same analytic counts) passes its gate."""
    with open(harness.CALIB_PATH) as f:
        data = json.load(f)
    assert Path(harness.CALIB_PATH).name == "calibrated_h100.json"
    assert "H100" in data["meta"]["device"]
    assert data["meta"]["cost_source"] == "analytic"
    assert harness.check(device="cpu") == []


def _gate_cases():
    base = harness.run_calibration(device="cpu")
    over = json.loads(json.dumps(base))
    k = "delivery_fit_rel_err"
    over["residuals"][k] = base["residuals"][k] * harness.RESIDUAL_SLACK * 1.01
    drift = json.loads(json.dumps(base))
    drift["constants"]["mac_mul_share"] *= 1.06
    return base, {"clean": base, "residual over": over, "drift 6%": drift}


def test_check_gives_the_reference_failure_lists(tmp_path):
    assert (harness.RESIDUAL_SLACK, harness.RESIDUAL_FLOOR) == (
        jharness.RESIDUAL_SLACK, jharness.RESIDUAL_FLOOR)
    base, cases = _gate_cases()
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(base))
    counts = {}
    for what, data in cases.items():
        got = harness.check(str(path), device="cpu", data=data)
        assert got == jharness.check(str(path), data=data), what
        counts[what] = len(got)
    assert counts == {"clean": 0, "residual over": 1, "drift 6%": 1}


def test_write_calibrated_round_trips(tmp_path):
    path = tmp_path / "refit.json"
    data = harness.write_calibrated(str(path), device="cpu")
    assert json.loads(path.read_text()) == json.loads(json.dumps(data))
    assert harness.check(str(path), device="cpu") == []
    assert harness.main(["--check", "--path", str(path),
                         "--device", "cpu"]) == 0
