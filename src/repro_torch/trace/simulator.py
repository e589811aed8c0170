"""Trace simulation: price a :class:`Scenario` over systems, batched.

``simulate`` maps the scenario's canonical constant-rate windows onto the
per-stream rows of a (cached) ``SystemGeometry`` and prices ALL windows x
systems in ONE vectorized roll-up (``schedule.window_rollup`` — no
per-window Python ``SystemPoint`` loop), then folds the window axis into
the numbers steady-state pricing cannot see:

  * average / peak / duration-weighted p99 power (memory and total),
  * deadline misses (windows where the aggregate duty exceeds 1),
  * per-segment reload / wake / standby energy,
  * battery life (mAh budget -> hours per scenario).

Window rates for a stream come from the scenario by stream NAME; a
system stream the scenario never mentions holds its steady-state rate.
A constant-rate scenario at the streams' own rates therefore reproduces
``schedule.price`` byte-for-byte — the parity oracle of
``tests/test_trace.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import columns, schedule
from repro_torch.trace.scenario import Scenario

# A typical XR glasses cell is a few hundred mAh at a nominal Li-ion
# voltage; the default budget matches the class of device the paper sizes.
BATTERY_VOLTAGE_V = 3.85
DEFAULT_BATTERY_MAH = 500.0


def battery_hours(avg_power_w, mah: float = DEFAULT_BATTERY_MAH,
                  volts: float = BATTERY_VOLTAGE_V):
    """Hours of scenario runtime a ``mah`` budget sustains at the given
    average power (elementwise; inf where the average power is 0)."""
    p = np.asarray(avg_power_w, float)
    with np.errstate(divide="ignore"):
        return np.where(p > 0.0, (mah / 1000.0) * volts / p, np.inf)


def _row_rates(geom: schedule.SystemGeometry, scenario: Scenario
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(t0s (W,), durations (W,), rates (W, R))``: the scenario's
    canonical windows mapped onto the geometry's stream rows.

    Scenario streams are matched by workload name; rows the scenario never
    names hold their steady-state rate. After mapping, adjacent windows
    whose FULL row vectors are equal are merged again (a scenario change
    touching only streams absent from every system collapses away)."""
    names = [sp.streams[k].name
             for sp in geom.spoints
             for k in range(len(sp.streams))]
    unknown = sorted(set(scenario.streams) - set(names))
    if unknown:
        raise ValueError(
            f"scenario {scenario.name!r} drives stream(s) {unknown!r} not "
            f"present in any system (streams: {sorted(set(names))!r})")
    t0s, durs, mat = scenario.rate_matrix(names)
    rates = np.where(np.isin(np.array(names), scenario.streams)[None, :],
                     mat, geom.ips[None, :])
    keep = np.ones(len(t0s), bool)
    keep[1:] = (rates[1:] != rates[:-1]).any(axis=1)
    if not keep.all():
        idx = np.flatnonzero(keep)
        durs = np.add.reduceat(durs, idx)
        t0s, rates = t0s[idx], rates[idx]
    return t0s, durs, rates


def _weighted_percentile(values: np.ndarray, weights: np.ndarray,
                         q: float) -> np.ndarray:
    """(S,) duration-weighted q-percentile of (W, S) per-window values:
    the smallest value v per column such that windows with value <= v
    cover at least ``q`` of the total duration."""
    order = np.argsort(values, axis=0)
    v_sorted = np.take_along_axis(values, order, axis=0)
    w_sorted = weights[order]
    cum = np.cumsum(w_sorted, axis=0) / weights.sum()
    pick = (cum >= q).argmax(axis=0)
    return np.take_along_axis(v_sorted, pick[None, :], axis=0)[0]


@dataclass(frozen=True)
class TraceReport:
    """Scalar per-system view of one simulated scenario."""
    point: schedule.SystemPoint
    scenario: str
    duration_s: float
    n_windows: int
    battery_mah: float
    # time-resolved (per canonical window, this system's column)
    window_t0: np.ndarray           # (W,)
    window_dur: np.ndarray          # (W,)
    window_p_mem_w: np.ndarray      # (W,)
    window_p_total_w: np.ndarray    # (W,)
    window_duty: np.ndarray         # (W,)
    # folded scalars
    avg_p_mem_w: float
    avg_p_total_w: float
    peak_p_mem_w: float
    peak_p_total_w: float
    p99_p_total_w: float
    miss_windows: int
    miss_time_s: float
    energy_j: float
    mem_energy_j: float
    reload_energy_j: float
    wake_energy_j: float
    standby_energy_j: float
    battery_h: float

    def __post_init__(self) -> None:
        columns.freeze_arrays(self)

    def to_row(self) -> Dict[str, Any]:
        """Tabular view (hooked by ``ResultSet._default_row``)."""
        p = self.point
        return dict(mode=p.mode, scenario=self.scenario,
                    duration_s=self.duration_s, windows=self.n_windows,
                    avg_p_mem_w=self.avg_p_mem_w,
                    avg_p_total_w=self.avg_p_total_w,
                    peak_p_total_w=self.peak_p_total_w,
                    p99_p_total_w=self.p99_p_total_w,
                    miss_windows=self.miss_windows,
                    miss_time_s=self.miss_time_s,
                    reload_mj=self.reload_energy_j * 1e3,
                    wake_mj=self.wake_energy_j * 1e3,
                    battery_h=self.battery_h)


@dataclass(frozen=True)
class TraceTable:
    """All systems of one simulation: the batched window columns plus the
    folded per-system summaries (shapes: (W, S) windows, (S,) summaries)."""
    scenario: Scenario
    cols: schedule.WindowColumns
    window_t0: np.ndarray           # (W,)
    window_dur: np.ndarray          # (W,)
    battery_mah: float
    # folded per-system columns (S,)
    avg_p_mem_w: np.ndarray
    avg_p_total_w: np.ndarray
    peak_p_mem_w: np.ndarray
    peak_p_total_w: np.ndarray
    p99_p_total_w: np.ndarray
    miss_windows: np.ndarray        # int
    miss_time_s: np.ndarray
    energy_j: np.ndarray
    mem_energy_j: np.ndarray
    reload_energy_j: np.ndarray
    wake_energy_j: np.ndarray
    standby_energy_j: np.ndarray
    battery_h: np.ndarray

    def __post_init__(self) -> None:
        columns.freeze_arrays(self)

    def __len__(self) -> int:
        return self.cols.geometry.n_systems

    @property
    def points(self) -> Tuple[schedule.SystemPoint, ...]:
        return self.cols.geometry.spoints

    @property
    def n_windows(self) -> int:
        return len(self.window_dur)

    def report(self, i: int) -> TraceReport:
        return TraceReport(
            point=self.points[i], scenario=self.scenario.name,
            duration_s=self.scenario.duration_s, n_windows=self.n_windows,
            battery_mah=self.battery_mah,
            window_t0=self.window_t0, window_dur=self.window_dur,
            window_p_mem_w=self.cols.p_mem_w[:, i],
            window_p_total_w=self.cols.p_total_w[:, i],
            window_duty=self.cols.duty[:, i],
            avg_p_mem_w=float(self.avg_p_mem_w[i]),
            avg_p_total_w=float(self.avg_p_total_w[i]),
            peak_p_mem_w=float(self.peak_p_mem_w[i]),
            peak_p_total_w=float(self.peak_p_total_w[i]),
            p99_p_total_w=float(self.p99_p_total_w[i]),
            miss_windows=int(self.miss_windows[i]),
            miss_time_s=float(self.miss_time_s[i]),
            energy_j=float(self.energy_j[i]),
            mem_energy_j=float(self.mem_energy_j[i]),
            reload_energy_j=float(self.reload_energy_j[i]),
            wake_energy_j=float(self.wake_energy_j[i]),
            standby_energy_j=float(self.standby_energy_j[i]),
            battery_h=float(self.battery_h[i]))

    def reports(self) -> List[TraceReport]:
        return [self.report(i) for i in range(len(self))]


def simulate(ev, spoints: Union[schedule.SystemPoint,
                                Sequence[schedule.SystemPoint]],
             scenario: Scenario,
             battery_mah: Optional[float] = None) -> TraceTable:
    """Simulate ``scenario`` over one or many systems in one batched pass.

    The geometry routes through ``ev.system_geometry`` — the same
    ``(points, "system")`` cache key steady-state pricing uses, so a trace
    over a placement lattice reuses the flattening ``system_rows`` built
    (and vice versa). Device tables are re-read on every call."""
    if isinstance(spoints, schedule.SystemPoint):
        spoints = (spoints,)
    pts = tuple(spoints)
    mah = DEFAULT_BATTERY_MAH if battery_mah is None else float(battery_mah)
    if not mah > 0.0:
        raise ValueError(f"battery_mah must be > 0, got {battery_mah!r}")
    geom = ev.system_geometry(pts)
    t0s, durs, rates = _row_rates(geom, scenario)
    cols = schedule.window_rollup(geom, rates)

    p_mem, p_tot = cols.p_mem_w, cols.p_total_w
    T = durs.sum()
    mem_e = durs @ p_mem
    tot_e = durs @ p_tot
    avg_mem, avg_tot = mem_e / T, tot_e / T
    miss = cols.duty > 1.0
    return TraceTable(
        scenario=scenario, cols=cols, window_t0=t0s, window_dur=durs,
        battery_mah=mah,
        avg_p_mem_w=avg_mem, avg_p_total_w=avg_tot,
        peak_p_mem_w=p_mem.max(axis=0), peak_p_total_w=p_tot.max(axis=0),
        p99_p_total_w=_weighted_percentile(p_tot, durs, 0.99),
        miss_windows=miss.sum(axis=0),
        miss_time_s=durs @ miss.astype(float),
        energy_j=tot_e, mem_energy_j=mem_e,
        reload_energy_j=durs @ cols.reload_w,
        wake_energy_j=durs @ (cols.wake_rate * cols.wake_j),
        standby_energy_j=durs @ (cols.idle_frac * cols.standby_w),
        battery_h=battery_hours(avg_tot, mah))


class TraceSimulator:
    """Thin OO front: an Evaluator bound to a battery budget.

    ``run`` prices any (system(s), scenario) pair through :func:`simulate`;
    repeated runs over the same points share the Evaluator's structural
    caches (specs, sized archs, plan geometry)."""

    def __init__(self, evaluator=None, battery_mah: float =
                 DEFAULT_BATTERY_MAH):
        if evaluator is None:
            from repro_torch.core.experiment import Evaluator
            evaluator = Evaluator(cache_reports=False)
        self.ev = evaluator
        self.battery_mah = float(battery_mah)

    def run(self, spoints, scenario: Union[str, Scenario],
            **scenario_kw) -> TraceTable:
        if isinstance(scenario, str):
            from repro_torch.trace.scenario import get_scenario
            scenario = get_scenario(scenario, **scenario_kw)
        return simulate(self.ev, spoints, scenario,
                        battery_mah=self.battery_mah)
