"""repro_torch.trace (the trace-driven XR system simulation) against
repro.trace, byte for byte: the scenario library, ``simulate`` tables for
the four scenarios over the SRAM/P0/P1 corners and a lattice hybrid, the
steady-state oracle, ``Evaluator.evaluate_trace``, ``trace_rows`` and
``dse.sweep_trace``, the Chrome trace document, the port's
``launch.trace`` against ``tools/trace.py`` and ``launch.dse_sweep``
against ``examples/dse_sweep.py``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import trace as jtrace
from repro.core import dse as jdse
from repro.core import experiment as jxp
from repro.core.placement import Placement as JPlacement
from repro.core.schedule import SystemPoint as JSystemPoint
from repro_torch import trace
from repro_torch.core import dse, schedule
from repro_torch.core import experiment as xp
from repro_torch.core.placement import Placement
from repro_torch.core.schedule import SystemPoint
from repro_torch.launch import dse_sweep
from repro_torch.launch import trace as ltrace
from repro_torch.trace.chrometrace import validate_events

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = ["idle", "gaming", "passthrough", "multi_user"]


def _systems(port=True):
    """The SRAM/P0/P1 corners in both contention modes, and one hybrid of
    the Simba placement lattice."""
    SP, P = (SystemPoint, Placement) if port else (JSystemPoint, JPlacement)
    X = (xp if port else jxp).XR_BUNDLE
    pts = [SP(X, "simba", 7, variant=v, mode=m)
           for v in ("sram", "p0", "p1") for m in ("reload", "union")]
    hyb = P.enumerate("simba", ("sram", "stt", "sot", "vgsot"))[137]
    return pts + [SP(X, "simba", 7, placement=hyb, mode="reload")]


def test_the_api_and_scenarios_are_the_references():
    assert trace.__all__ == jtrace.__all__
    assert (trace.BATTERY_VOLTAGE_V, trace.DEFAULT_BATTERY_MAH) == (
        jtrace.BATTERY_VOLTAGE_V, jtrace.DEFAULT_BATTERY_MAH)
    assert list(trace.SCENARIOS) == list(jtrace.SCENARIOS) == SCENARIOS
    for name in SCENARIOS:
        for kw in ({}, {"duration_s": 97.5}):
            s, js = trace.get_scenario(name, **kw), jtrace.get_scenario(
                name, **kw)
            assert repr(s) == repr(js)
            assert repr(s.windows()) == repr(js.windows())
            assert repr(s.canonical()) == repr(js.canonical())
            assert repr(s.subdivide(3)) == repr(js.subdivide(3))
        for get in (trace.get_scenario, jtrace.get_scenario):
            if name != "passthrough":     # the constant anchor: no segments
                with pytest.raises(ValueError, match="must exceed"):
                    get(name, duration_s=1.0)


def _arrays(tab):
    out = {f.name: getattr(tab, f.name) for f in dataclasses.fields(tab)
           if isinstance(getattr(tab, f.name), np.ndarray)}
    out.update({f"cols.{f.name}": getattr(tab.cols, f.name)
                for f in dataclasses.fields(tab.cols)
                if isinstance(getattr(tab.cols, f.name), np.ndarray)})
    return out


@pytest.mark.parametrize("battery_mah", [None, 1234.5])
@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_tables_equal_the_reference(name, battery_mah):
    """Every window and folded column of the table, and each system's
    report row."""
    tab = trace.simulate(xp.Evaluator(), _systems(),
                         trace.get_scenario(name), battery_mah=battery_mah)
    jtab = jtrace.simulate(jxp.Evaluator(), _systems(False),
                           jtrace.get_scenario(name),
                           battery_mah=battery_mah)
    a, b = _arrays(tab), _arrays(jtab)
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert tab.n_windows == jtab.n_windows and tab.battery_mah == \
        jtab.battery_mah
    assert [repr(p) for p in tab.points] == [repr(p) for p in jtab.points]
    for i in range(len(tab)):
        assert json.dumps(tab.report(i).to_row()) == json.dumps(
            jtab.report(i).to_row())


def test_constant_scenario_is_the_steady_state_report():
    """The reference's oracle on the port: a constant-rate scenario at the
    streams' own rates gives the steady-state ``SystemPoint`` pricing,
    byte for byte."""
    ev = xp.Evaluator()
    pts = _systems()
    sc = trace.Scenario.constant({s.name: s.ips for s in xp.XR_BUNDLE},
                                 30.0)
    stab, tr = ev.system_table(pts), ev.trace_table(pts, sc)
    assert tr.n_windows == 1
    for k in ("p_mem_w", "duty", "feasible", "dyn_w", "reload_w",
              "wake_rate", "stream_duty", "switch_rate"):
        assert np.array_equal(getattr(tr.cols, k)[0], getattr(stab, k)), k
    assert np.array_equal(tr.avg_p_mem_w, stab.p_mem_w)
    assert np.array_equal(tr.peak_p_mem_w, stab.p_mem_w)


def test_evaluate_trace_equals_the_reference():
    sc, jsc = trace.get_scenario("gaming"), jtrace.get_scenario("gaming")
    rs = xp.Evaluator().evaluate_trace(_systems(), sc)
    jrs = jxp.Evaluator().evaluate_trace(_systems(False), jsc)
    assert rs.name == jrs.name == "trace:gaming"
    assert [json.dumps(r.to_row()) for _, r in rs] == \
        [json.dumps(r.to_row()) for _, r in jrs]
    sim = trace.TraceSimulator(battery_mah=800.0).run(_systems()[:2],
                                                      "multi_user")
    jsim = jtrace.TraceSimulator(battery_mah=800.0).run(_systems(False)[:2],
                                                        "multi_user")
    assert np.array_equal(sim.battery_h, jsim.battery_h)


@pytest.mark.parametrize("kw", [
    {"scenario": "idle"},
    {"scenario": "gaming", "mode": "union", "battery_mah": 300.0},
    {"scenario": "multi_user", "arch": "eyeriss", "node": 28}],
    ids=["idle", "gaming-union", "multi_user-eyeriss"])
def test_trace_rows_and_sweep_trace_equal_the_reference(kw):
    got = json.dumps(xp.trace_rows(xp.Evaluator(), **kw))
    assert got == json.dumps(jxp.trace_rows(jxp.Evaluator(), **kw))
    assert got == json.dumps(dse.sweep_trace(**kw))
    assert got == json.dumps(jdse.sweep_trace(**kw))
    rows = json.loads(got)
    assert [r["rank"] for r in rows] == list(range(1, len(rows) + 1))
    hours = [r["battery_h"] for r in rows]
    assert hours == sorted(hours, reverse=True)


@pytest.mark.parametrize("systems", [None, [0, 6]])
def test_chrome_trace_equals_the_reference(systems, tmp_path):
    tab = trace.simulate(xp.Evaluator(), _systems(),
                         trace.get_scenario("gaming"))
    jtab = jtrace.simulate(jxp.Evaluator(), _systems(False),
                           jtrace.get_scenario("gaming"))
    doc = trace.chrome_trace(tab, systems)
    assert json.dumps(doc) == json.dumps(jtrace.chrome_trace(jtab, systems))
    assert validate_events(doc) == []
    trace.write_chrome_trace(tab, str(tmp_path / "a.json"), systems)
    jtrace.write_chrome_trace(jtab, str(tmp_path / "b.json"), systems)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert validate_events({}) == ["traceEvents missing or empty"]


def _run(script, args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(ROOT / script), *args],
                          cwd=cwd, env=env, check=True, capture_output=True,
                          text=True, timeout=120).stdout


@pytest.mark.parametrize("args", [
    ["--sweep", "--scenario", "gaming", "--top", "0"],
    ["--scenario", "passthrough", "--placement", "gwb=stt,pe_wb=sot",
     "--battery-mah", "700", "--trace-out", "chrome.json"],
    ["--scenario", "multi_user", "--placement", "sot", "--duration", "75"]],
    ids=["sweep", "one-placement", "uniform"])
def test_trace_launcher_equals_the_tool(args, tmp_path, capsys,
                                        monkeypatch):
    """``launch.trace`` and ``tools/trace.py``: the same rows JSON, Chrome
    trace and printed lines."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _run("tools/trace.py", [*args, "--out", "rows.json"],
                tmp_path / "ref")
    monkeypatch.chdir(tmp_path / "port")
    ltrace.main([*args, "--out", "rows.json"])
    assert capsys.readouterr().out == want
    for f in os.listdir(tmp_path / "ref"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes(), f


def test_dse_sweep_launcher_prints_the_examples_lines(tmp_path, capsys):
    """Every section of ``examples/dse_sweep.py``, the streaming frontier
    and the trace plane included, line for line."""
    want = _run("examples/dse_sweep.py", [], tmp_path)
    dse_sweep.main()
    got = capsys.readouterr().out
    assert got == want
    for title in ("streaming frontier", "trace: gaming",
                  "idle-scenario battery life"):
        assert title in got


def test_product_iter_and_modes_are_the_references():
    from repro.core import schedule as jschedule
    from repro.core.space import DesignSpace as JDesignSpace
    from repro_torch.core.space import DesignSpace
    assert schedule.MODES == jschedule.MODES
    lazy = DesignSpace.product_iter("s", workload=("detnet", "edsnet"),
                                    arch="simba", node=(45, 7))
    jlazy = JDesignSpace.product_iter("s", workload=("detnet", "edsnet"),
                                      arch="simba", node=(45, 7))
    assert [repr(p) for p in lazy] == [repr(p) for p in jlazy]
    assert [repr(p) for p in lazy] == [repr(p) for p in DesignSpace.product(
        "s", workload=("detnet", "edsnet"), arch="simba", node=(45, 7))]
