"""Every public symbol of ``repro_torch.core.columns`` against the same
symbol of ``repro.core.columns``, on the same small space: the port's
columnar pricing core, held symbol by symbol (both are the same numpy, so
equality is exact). Each case names its symbol in code, so the port's PO
gate (``repro_torch.analysis.po``) sees its oracle.
"""
import dataclasses
import types

import numpy as np
import pytest

from repro.core import columns as ref_columns
from repro.core import experiment as ref_xp
from repro_torch.core import columns
from repro_torch.core import experiment as xp

IPS_GRID = np.geomspace(0.1, 100.0, 7)


def _space(x):
    """The Table-3 space at 7 nm, a CPU point and a hybrid at 28 nm."""
    pts = list(x.table3_space(node=7))
    pts.append(x.DesignPoint(workload="detnet", arch="cpu", node=45,
                             variant="sram"))
    pts.append(x.DesignPoint(workload="edsnet", arch="eyeriss", node=28,
                             variant="p1", nvm="sot"))
    return pts


def _build(x, cols):
    ev = x.Evaluator()
    pts = _space(x)
    plan = ev.plan(pts)
    table = ev.evaluate_table(pts)
    tts = [ev.traffic(p) for p in pts]
    return types.SimpleNamespace(
        cols=cols, ev=ev, pts=pts, plan=plan, table=table, tts=tts,
        area=ev.area_table(pts), bases=[ev.base_arch(p) for p in pts])


@pytest.fixture(scope="module")
def both():
    return _build(ref_xp, ref_columns), _build(xp, columns)


def _same(a, b, where="result"):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


def _nvm_sram_rows(ns):
    """(p0, p1) rows of each Table-3 pair and its sram row twice."""
    idx = {(p.workload_name, p.arch, p.variant): i
           for i, p in enumerate(ns.pts)}
    pairs = [(w, a) for w, a, v in idx if v == "sram" and (w, a, "p1") in idx]
    nvm = [idx[w, a, v] for w, a in pairs for v in ("p0", "p1")]
    sram = [idx[w, a, "sram"] for w, a in pairs for _ in (0, 1)]
    return nvm, sram


CASES = {
    # --- TrafficTable
    "TrafficTable.from_accesses": lambda ns: [
        ns.cols.TrafficTable.from_accesses(ns.ev.accesses(p, b), b)
        for p, b in zip(ns.pts, ns.bases)],
    "TrafficTable.map_specs": lambda ns: [
        ns.cols.TrafficTable.map_specs(
            ns.ev.specs(p.workload, p.extract_kw, bits=p.precision()), b)
        for p, b in zip(ns.pts, ns.bases)],
    "TrafficTable.num_layers": lambda ns: [t.num_layers for t in ns.tts],
    "TrafficTable.num_levels": lambda ns: [t.num_levels for t in ns.tts],
    "TrafficTable.total_read_bits": lambda ns: [t.total_read_bits
                                                for t in ns.tts],
    "TrafficTable.total_write_bits": lambda ns: [t.total_write_bits
                                                 for t in ns.tts],
    "TrafficTable.total_macs": lambda ns: [t.total_macs for t in ns.tts],
    "TrafficTable.total_delivery_macs": lambda ns: [
        t.total_delivery_macs for t in ns.tts],
    "TrafficTable.total_compute_cycles": lambda ns: [
        t.total_compute_cycles for t in ns.tts],
    "TrafficTable.mul_frac": lambda ns: [t.mul_frac for t in ns.tts],
    "TrafficTable.issue_ratio": lambda ns: [t.issue_ratio for t in ns.tts],
    "TrafficTable.dlvw_frac": lambda ns: [t.dlvw_frac for t in ns.tts],
    "TrafficTable.aggregate": lambda ns: [t.aggregate() for t in ns.tts],
    "TrafficTable.row": lambda ns: [t.row(i) for t in ns.tts
                                    for i in range(t.num_layers)],
    # --- plans
    "PricingPlan.n_points": lambda ns: ns.plan.n_points,
    "group_geometry": lambda ns: ns.cols.group_geometry(ns.tts),
    "build_plan": lambda ns: ns.cols.build_plan(
        ns.tts, range(len(ns.tts)), tuple(ns.pts),
        [ns.ev._resolve_nvm(p) for p in ns.pts]),
    "unit_energy_pj_per_bit": lambda ns: ns.cols.unit_energy_pj_per_bit(
        ns.plan),
    "price": lambda ns: ns.cols.price(ns.plan),
    # --- EnergyTable
    "EnergyTable.points": lambda ns: ns.table.points,
    "EnergyTable.macs": lambda ns: ns.table.macs,
    "EnergyTable.mem_read_pj": lambda ns: ns.table.mem_read_pj,
    "EnergyTable.mem_write_pj": lambda ns: ns.table.mem_write_pj,
    "EnergyTable.mem_pj": lambda ns: ns.table.mem_pj,
    "EnergyTable.buffer_pj": lambda ns: ns.table.buffer_pj,
    "EnergyTable.total_pj": lambda ns: ns.table.total_pj,
    "EnergyTable.edp": lambda ns: ns.table.edp,
    "EnergyTable.standby_w": lambda ns: ns.table.standby_w,
    "EnergyTable.weight_standby_w": lambda ns: ns.table.weight_standby_w,
    "EnergyTable.max_ips": lambda ns: ns.table.max_ips,
    "EnergyTable.wake_energy_j": lambda ns: ns.table.wake_energy_j,
    "EnergyTable.mem_pj_by_cls": lambda ns: [
        ns.table.mem_pj_by_cls(c) for c in ("weight", "input", "output",
                                            "unified")],
    "EnergyTable.memory_power_at": lambda ns: [
        ns.table.memory_power_at(10.0),
        ns.table.memory_power_at(np.linspace(0.5, 30.0, len(ns.pts)))],
    "EnergyTable.weight_memory_power_at": lambda ns: (
        ns.table.weight_memory_power_at(10.0)),
    "EnergyTable.memory_power_curves": lambda ns: (
        ns.table.memory_power_curves(IPS_GRID)),
    "EnergyTable.column": lambda ns: [
        ns.table.column(m, ips=3.0) for m in ("edp", "total_pj", "pmem",
                                               "latency_s")],
    "EnergyTable.row": lambda ns: ns.table.row(len(ns.pts) - 1),
    "EnergyTable.rows": lambda ns: ns.table.rows(),
    "PowerTable.curve": lambda ns: [
        ns.table.memory_power_curves(IPS_GRID).curve(i)
        for i in range(len(ns.pts))],
    "crossover_ips": lambda ns: ns.cols.crossover_ips(
        ns.table, *_nvm_sram_rows(ns)),
    # --- AreaTable
    "area": lambda ns: ns.cols.area(ns.ev.plan(ns.pts, for_area=True)),
    "AreaTable.memory_mm2": lambda ns: ns.area.memory_mm2,
    "AreaTable.total_mm2": lambda ns: ns.area.total_mm2,
    "AreaTable.row": lambda ns: ns.area.row(0),
    "AreaTable.rows": lambda ns: ns.area.rows(),
}


@pytest.mark.parametrize("symbol", list(CASES))
def test_symbol_equals_the_reference(symbol, both):
    ref_ns, port_ns = both
    _same(CASES[symbol](ref_ns), CASES[symbol](port_ns), symbol)


def test_every_public_symbol_has_a_case():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(columns))
    public = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            public.add(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            public |= {f"{node.name}.{s.name}" for s in node.body
                       if isinstance(s, ast.FunctionDef)
                       and not s.name.startswith("_")}
    assert public == set(CASES) | {"freeze_arrays"}


def test_freeze_arrays_equals_the_reference():
    @dataclasses.dataclass
    class Box:
        a: np.ndarray
        b: float

    ref_box, box = Box(np.ones(3), 1.0), Box(np.ones(3), 1.0)
    ref_columns.freeze_arrays(ref_box)
    columns.freeze_arrays(box)
    assert box.a.flags.writeable is ref_box.a.flags.writeable is False
    with pytest.raises(ValueError):
        box.a[0] = 2.0


def test_tables_are_read_only(both):
    _, ns = both
    with pytest.raises(ValueError):
        ns.table.read_pj[0, 0] = 1.0
    with pytest.raises(ValueError):
        ns.tts[0].read_bits[0, 0] = 1.0
    with pytest.raises(ValueError):
        ns.area.levels_mm2[0, 0] = 1.0
