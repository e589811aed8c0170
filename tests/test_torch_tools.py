"""The port's twins of the remaining tools (``launch.gridsearch``,
``launch.hillclimb``'s DSE and system modes, ``launch.calibrate``) and its
copy of ``hypolite``, held to the reference on the CPU: the same results
and the same printed lines (elapsed-time fields stripped)."""
import argparse
import importlib.util
import os
import re
from pathlib import Path

import pytest
import torch

from repro.testing import hypolite as ref_hypolite
from repro_torch.launch import calibrate, gridsearch, hillclimb
from repro_torch.testing import hypolite

ROOT = Path(__file__).resolve().parents[1]


def _tool(name):
    """Import tools/<name>.py as a module; the XLA flags that the hillclimb
    tool sets at import are put back, so no later test of this process
    sees them."""
    saved = os.environ.get("XLA_FLAGS")
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


TOOL_GRID = _tool("gridsearch")
TOOL_HILL = _tool("hillclimb")
TOOL_CAL = _tool("calibrate")


def _stripped(text):
    return re.sub(r"\(\d+\.\ds", "(Xs", text)


# --- gridsearch --------------------------------------------------------------

GRID_CASES = {
    "int8": dict(limit=12),
    "weight-bits-4": dict(limit=12, weight_bits=4),
    "placement-gwb": dict(limit=12, placement="gwb=stt"),
    "system": dict(limit=12, system=True),
}


@pytest.mark.parametrize("case", list(GRID_CASES))
def test_gridsearch_run_equals_the_tool(case):
    kw = GRID_CASES[case]
    want = TOOL_GRID.run(quiet=True, **kw)
    got = gridsearch.run(quiet=True, **kw)
    assert got == want
    results = got[0] if kw.get("system") else got
    assert len(results) == 12 and all(len(r[2]) == 4 for r in results)
    if kw.get("system"):
        assert set(got[1]) == {(a, v) for a in ("simba", "eyeriss")
                               for v in ("p0", "p1")}


def test_gridsearch_restores_the_device_tables():
    from repro_torch.core import devices as dev
    before = (dev.SRAM_LEAK_UW_PER_KB_45, dev.CELL_FRAC_MIN,
              dev.CELL_FRAC_SLOPE, dev.DEVICES["vgsot"])
    gridsearch.run(limit=3, quiet=True, system=True)
    assert (dev.SRAM_LEAK_UW_PER_KB_45, dev.CELL_FRAC_MIN,
            dev.CELL_FRAC_SLOPE, dev.DEVICES["vgsot"]) == before
    with pytest.raises(ValueError, match="SEL=TECH"):
        gridsearch.parse_placement("gwb")


def test_gridsearch_cli_prints_the_tools_lines(capsys, monkeypatch):
    argv = ["--limit", "6", "--top", "2", "--weight-bits", "4", "--system"]
    gridsearch.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["gridsearch.py"] + argv)
    TOOL_GRID.main()
    want = capsys.readouterr().out
    assert got == want and got.count("err=") == 2
    assert "-- system probe (best cell)" in got


# --- hillclimb: DSE and system modes ----------------------------------------

HILL_CASES = {
    "dse-detnet-edp": ["--dse", "--workload", "detnet", "--objective", "edp"],
    "dse-detnet-energy": ["--dse", "--workload", "detnet", "--objective",
                          "energy"],
    "dse-edsnet-pmem": ["--dse", "--workload", "edsnet", "--objective",
                        "pmem", "--ips", "0.1"],
    "system-xr-bundle": ["--system"],
    "system-streams": ["--system", "--stream", "detnet=30",
                       "--stream", "edsnet=1"],
}


def _tool_namespace(argv):
    a = argparse.Namespace(dse=False, system=False, stream=[],
                           workload="detnet", objective="edp", ips=10.0)
    it = iter(argv)
    for tok in it:
        key = tok.lstrip("-")
        if key in ("dse", "system"):
            setattr(a, key, True)
        elif key == "stream":
            a.stream.append(next(it))
        else:
            val = next(it)
            setattr(a, key, float(val) if key == "ips" else val)
    return a


@pytest.mark.parametrize("case", list(HILL_CASES))
def test_hillclimb_prints_the_tools_lines(case, capsys):
    argv = HILL_CASES[case]
    hillclimb.main(argv)
    got = capsys.readouterr().out
    a = _tool_namespace(argv)
    (TOOL_HILL.system_main if a.system else TOOL_HILL.dse_main)(a)
    want = capsys.readouterr().out
    assert _stripped(got) == _stripped(want)
    assert "local optimum after" in got


def test_hillclimb_module_surface_equals_the_tool():
    from repro.core.space import DesignPoint as RefPoint
    from repro_torch.core.space import DesignPoint
    assert hillclimb.DSE_AXES == TOOL_HILL.DSE_AXES
    assert hillclimb.SYSTEM_AXES == TOOL_HILL.SYSTEM_AXES
    assert [(s.name, s.ips) for s in hillclimb.parse_streams(
        ["detnet=10", "edsnet=0.1"])] == [(s.name, s.ips) for s in
                                          TOOL_HILL.parse_streams(
                                              ["detnet=10", "edsnet=0.1"])]
    with pytest.raises(ValueError, match="WORKLOAD=IPS"):
        hillclimb.parse_streams(["detnet"])
    p = DesignPoint(workload="detnet", arch="simba", node=7, variant="p1")
    rp = RefPoint(workload="detnet", arch="simba", node=7, variant="p1")
    assert (repr(hillclimb._arch_move(p, "eyeriss"))
            == repr(TOOL_HILL._arch_move(rp, "eyeriss")))
    assert ([repr(m) for m in hillclimb.placement_moves(p)]
            == [repr(m) for m in TOOL_HILL.placement_moves(rp)])
    with pytest.raises(AttributeError):
        hillclimb.NO_SUCH_NAME
    with pytest.raises(SystemExit):
        hillclimb.main([])            # roofline mode needs --arch and --shape


# --- calibrate ---------------------------------------------------------------

def test_calibrate_tables_print_the_tools_lines(capsys):
    data = calibrate.tables()
    got = capsys.readouterr().out
    TOOL_CAL.tables()
    want = capsys.readouterr().out
    assert got == want
    assert calibrate.TARGETS_T3 == TOOL_CAL.TARGETS_T3
    assert calibrate.TARGETS_T2 == TOOL_CAL.TARGETS_T2
    assert set(data["table3"]) == set(calibrate.TARGETS_T3)
    assert [r["arch"] for r in data["table2"]] == ["simba", "eyeriss"]


def test_calibrate_kernels_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.main(["--kernels"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate.main(["--kernels", "--check"])


def test_calibrate_kernels_check_on_the_cpu(capsys):
    assert calibrate.main(["--kernels", "--check", "--device", "cpu"]) == 0
    assert "calibrate --kernels --check: OK" in capsys.readouterr().out


def test_calibrate_kernels_write_goes_to_the_ports_refit(monkeypatch,
                                                         capsys):
    from repro_torch.calibrate import harness
    calls = []
    fake = {"constants": {"c": 1.0}, "residuals": {"r": 0.0}, "samples": []}
    monkeypatch.setattr(harness, "write_calibrated",
                        lambda **kw: calls.append(kw) or fake)
    assert calibrate.main(["--kernels", "--write", "--device", "cpu"]) == 0
    assert calls == [{"device": "cpu"}]
    assert harness.CALIB_PATH.endswith("calibrated_h100.json")
    assert "calibrated_h100.json" in capsys.readouterr().out


# --- hypolite ----------------------------------------------------------------

def _draws(mod, strategies):
    seen = []

    @mod.settings(max_examples=12)
    @mod.given(*strategies)
    def probe(*args):
        seen.append(args)

    probe()
    return seen


@pytest.mark.parametrize("kind", ["integers", "floats", "sampled_from",
                                  "booleans"])
def test_hypolite_draws_equal_the_reference(kind):
    def strats(mod):
        st = mod.strategies
        return {"integers": (st.integers(min_value=-5, max_value=40),),
                "floats": (st.floats(min_value=0.1, max_value=9.5),),
                "sampled_from": (st.sampled_from(["a", "b", "c"]),
                                 st.integers(min_value=0, max_value=3)),
                "booleans": (st.booleans(),)}[kind]
    want = _draws(ref_hypolite, strats(ref_hypolite))
    got = _draws(hypolite, strats(hypolite))
    assert got == want and len(got) == 12
