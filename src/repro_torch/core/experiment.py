"""Experiment engine: cached + batched evaluation over a ``DesignSpace``.

The expensive per-point work of the DSE pipeline is strictly layered:

    extract specs  ->  size buffers  ->  build arch  ->  map (Timeloop-lite)
    (model plan)       (suite max)       (banked macros)  (access counts)
                                   -> price (Accelergy-lite, per variant/node)

Everything left of ``price`` is *pricing-independent*: access counts are set
by buffer capacities, which P0/P1/node do not change (see ``core.dataflow``).
``Evaluator`` memoizes each layer across a space, so a 9-variant x 2-node
sweep extracts each workload once and maps each (workload, sized-arch) pair
once; only the cheap analytic pricing runs per point. Pricing itself is
columnar (``core.columns``): the whole space is flattened to a cached
``PricingPlan`` and priced in ONE vectorized pass (``evaluate_table``);
``evaluate`` materializes ``EnergyReport`` rows as thin views over the
resulting ``EnergyTable``.

Pricing deliberately re-reads the device tables (``core.devices``) on every
call: calibration tools mutate those constants mid-run, so only *structural*
state (specs / sizing / arch / mapping) is cached unconditionally, while
``EnergyReport`` caching is opt-out via ``Evaluator(cache_reports=False)``.

The paper's figures/tables are registered in ``SWEEPS`` as declarative
spaces + row builders; ``core.dse`` keeps the legacy function names as thin
shims over this registry.
"""
from __future__ import annotations

import dataclasses
import json
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.configs.base import ConvLayerSpec, ModelConfig, XRConfig
from repro_torch.core import area as area_mod
from repro_torch.core import columns
from repro_torch.core import devices as dev
from repro_torch.core import nvm as nvm_mod
from repro_torch.core import schedule
from repro_torch.core import workload as wl
from repro_torch.core.archspec import ArchSpec, get_arch
from repro_torch.core.dataflow import (map_workload, map_workload_columns,
                                       required_act_kb, required_weight_kb)
from repro_torch.core.energy import EnergyReport, price
from repro_torch.core.placement import Placement
from repro_torch.core.space import Bind, DesignPoint, DesignSpace, PAPER_SUITE

# paper §5: application minimum inference rates
IPS_MIN = {"detnet": 10.0, "edsnet": 0.1}
# paper §2/§5: per-application required throughputs (from [3, 9])
IPS_APP = {"detnet": 40.0, "edsnet": 6.0}

NODES_FIG2F = (45, 40, 28, 22, 7)
PAPER_NODES = (28, 7)

# Activation buffers are capped: beyond this, layers stream row tiles from
# the frame/line buffers (the pipeline's FA stage, outside the accelerator).
ACT_CAP_KB = 1024.0

Workload = Union[str, XRConfig, ModelConfig, Sequence[ConvLayerSpec]]


def extract_specs(workload: Workload, **kw) -> List[ConvLayerSpec]:
    """Workload -> layer descriptors (uncached; Evaluator caches this)."""
    if isinstance(workload, str):
        from repro_torch.configs import get_config
        return wl.extract(get_config(workload), **kw)
    if isinstance(workload, (XRConfig, ModelConfig)):
        return wl.extract(workload, **kw)
    return list(workload)


Precision = Tuple[Optional[int], Optional[int], Optional[int]]
_DEFAULT_BITS: Precision = (None, None, None)


def apply_precision(specs: Sequence[ConvLayerSpec],
                    bits: Precision) -> List[ConvLayerSpec]:
    """Override the (weight, act, psum) operand widths of every layer;
    ``None`` entries keep each spec's own width."""
    changes = {k: v for k, v in zip(("weight_bits", "act_bits", "psum_bits"),
                                    bits) if v is not None}
    if not changes:
        return list(specs)
    return [dataclasses.replace(s, **changes) for s in specs]


def size_arch(arch_name: str, specs: Sequence[ConvLayerSpec],
              pe_config: str = "v2",
              full_weight_kb: Optional[float] = None,
              full_act_kb: Optional[float] = None) -> ArchSpec:
    """Build the arch with workload-sized buffers (paper Fig 2d method)."""
    # `is not None`: a legitimate 0.0/tiny override must not silently
    # re-derive the sizing from the specs (it still clamps to one bank).
    w_kb = (full_weight_kb if full_weight_kb is not None
            else required_weight_kb(specs))
    a_kb = (full_act_kb if full_act_kb is not None
            else required_act_kb(specs))
    a_kb = min(a_kb, ACT_CAP_KB)
    # round up to the bank size to avoid phantom fractional banks
    w_kb = max(256.0, math.ceil(w_kb / 256.0) * 256.0)
    a_kb = max(128.0, math.ceil(a_kb / 128.0) * 128.0)
    if arch_name in ("cpu", "xr-npe"):   # sequential engines: no PE array
        return get_arch(arch_name, weight_kb=w_kb, act_kb=a_kb)
    return get_arch(arch_name, pe_config=pe_config, weight_kb=w_kb,
                    act_kb=a_kb)


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class Evaluator:
    """Memoizing evaluator for DesignPoints / DesignSpaces.

    ``cache_reports=False`` keeps only the structural caches (extraction,
    sizing, arch construction, mapping) — required when device-table
    constants are being mutated between calls (calibration / grid search),
    since those only affect pricing.
    """

    def __init__(self, cache_reports: bool = True):
        self._cache_reports = cache_reports
        self._specs: Dict[Tuple, List[ConvLayerSpec]] = {}
        self._suite: Dict[Tuple[str, ...], Tuple[float, float]] = {}
        self._archs: Dict[Tuple, ArchSpec] = {}
        self._maps: Dict[Tuple, list] = {}
        self._traffic: Dict[Tuple, columns.TrafficTable] = {}
        # LRU-bounded: plans are keyed by the full point tuple, so one-off
        # spaces (hillclimb neighborhoods) would otherwise accumulate
        # forever; repeated spaces (gridsearch cells) stay resident.
        # also holds schedule.SystemGeometry values ((pts, "system") keys)
        self._plans: "OrderedDict[Tuple, Union[columns.PricingPlan, schedule.SystemGeometry]]" = OrderedDict()  # noqa: E501
        self._plans_max = 64
        self._reports: Dict[DesignPoint, EnergyReport] = {}
        self._areas: Dict[DesignPoint, area_mod.AreaReport] = {}
        self.stats: Dict[str, List[int]] = {
            k: [0, 0] for k in ("specs", "suite", "arch", "map", "traffic",
                                "plan", "report", "area")}

    def _tick(self, cache: str, hit: bool) -> None:
        self.stats[cache][0 if hit else 1] += 1

    def cache_info(self) -> Dict[str, Tuple[int, int]]:
        """{cache_name: (hits, misses)}."""
        return {k: tuple(v) for k, v in self.stats.items()}

    # --- structural layers (always cached) ---------------------------------
    def specs(self, workload: Workload,
              extract_kw: Tuple[Tuple[str, Any], ...] = (),
              bits: Precision = _DEFAULT_BITS) -> List[ConvLayerSpec]:
        key = (workload if not isinstance(workload, list) else tuple(workload),
               tuple(extract_kw), tuple(bits))
        hit = key in self._specs
        self._tick("specs", hit)
        if not hit:
            if any(b is not None for b in bits):
                # derive from the cached default-width extraction: precision
                # overrides never re-run the (torch-touching) extractor
                base = self.specs(workload, extract_kw)
                self._specs[key] = apply_precision(base, bits)
            else:
                self._specs[key] = extract_specs(workload, **dict(extract_kw))
        return self._specs[key]

    def suite_sizes(self, suite: Sequence[str] = PAPER_SUITE,
                    bits: Precision = _DEFAULT_BITS) -> Tuple[float, float]:
        """(weight_kb, act_kb) sized for the max over the workload suite at
        the given operand widths (one silicon design per precision corner)."""
        key = (tuple(suite), tuple(bits))
        hit = key in self._suite
        self._tick("suite", hit)
        if not hit:
            all_specs = [self.specs(w, bits=bits) for w in key[0]]
            w_kb = max(required_weight_kb(s) for s in all_specs)
            a_kb = min(ACT_CAP_KB, max(required_act_kb(s) for s in all_specs))
            self._suite[key] = (w_kb, a_kb)
        return self._suite[key]

    def _sizing(self, point: DesignPoint) -> Tuple[Optional[float],
                                                   Optional[float]]:
        """Buffer sizing for the point: suite max (one-silicon method) when
        the workload is a named member of the point's suite, else None (size
        for the workload alone)."""
        if (point.suite and isinstance(point.workload, str)
                and point.workload in point.suite):
            return self.suite_sizes(point.suite, bits=point.precision())
        return (None, None)

    def base_arch(self, point: DesignPoint) -> ArchSpec:
        """Sized, SRAM-technology arch for the point (variant not applied)."""
        w_kb, a_kb = self._sizing(point)
        if w_kb is None:
            specs = self.specs(point.workload, point.extract_kw,
                               bits=point.precision())
            key = (point.arch, point.pe_config, point.workload_key())
        else:
            specs = ()
            key = (point.arch, point.pe_config, w_kb, a_kb)
        hit = key in self._archs
        self._tick("arch", hit)
        if not hit:
            self._archs[key] = size_arch(point.arch, specs, point.pe_config,
                                         full_weight_kb=w_kb,
                                         full_act_kb=a_kb)
        return self._archs[key]

    def sized_arch(self, arch_name: str, pe_config: str, w_kb: float,
                   a_kb: float) -> ArchSpec:
        """Sized, SRAM-technology arch for EXPLICIT buffer sizes — the
        system plane's entry into the arch cache (``core.schedule`` sizes
        for the max/union over a SystemPoint's streams). Shares cache keys
        with the suite-sized ``base_arch`` path, so a single-stream system
        and the equivalent suite point build the arch once."""
        key = (arch_name, pe_config, w_kb, a_kb)
        hit = key in self._archs
        self._tick("arch", hit)
        if not hit:
            self._archs[key] = size_arch(arch_name, (), pe_config,
                                         full_weight_kb=w_kb,
                                         full_act_kb=a_kb)
        return self._archs[key]

    def accesses(self, point: DesignPoint,
                 base: Optional[ArchSpec] = None) -> list:
        """Mapped access counts — variant/node-independent, cached per
        (workload, sized arch)."""
        base = base or self.base_arch(point)
        key = (point.workload_key(), base)
        hit = key in self._maps
        self._tick("map", hit)
        if not hit:
            specs = self.specs(point.workload, point.extract_kw,
                               bits=point.precision())
            self._maps[key] = map_workload(specs, base)
        return self._maps[key]

    def traffic(self, point: DesignPoint,
                base: Optional[ArchSpec] = None) -> columns.TrafficTable:
        """Columnar access counts for the point's mapping group — the
        vectorized mapper's output, cached per (workload, sized arch).
        ``accesses`` above is the scalar-oracle counterpart."""
        base = base or self.base_arch(point)
        key = (point.workload_key(), base)
        hit = key in self._traffic
        self._tick("traffic", hit)
        if not hit:
            specs = self.specs(point.workload, point.extract_kw,
                               bits=point.precision())
            self._traffic[key] = map_workload_columns(specs, base)
        return self._traffic[key]

    def plan(self, points: Sequence[DesignPoint],
             for_area: bool = False) -> columns.PricingPlan:
        """Geometry flattening of a whole space (cached): traffic groups +
        per-point coordinates -> one ``PricingPlan``. Plans hold no device
        constants, so they stay valid across device-table mutation — the
        gridsearch hot loop re-prices a cached plan every cell."""
        pts = tuple(points)
        default = "vgsot" if for_area else "stt"
        return self._cached_plan(
            (pts, for_area),
            lambda: self.assemble_plan(((p, self.base_arch(p)) for p in pts),
                                       default=default))

    def assemble_plan(self, pairs, default: str) -> columns.PricingPlan:
        """Shared plan assembly for (point, sized arch) pairs: group by
        mapped traffic group, flatten, resolve per-point default NVMs —
        the ONE implementation behind ``plan``, the system energy plane
        (``schedule.system_geometry``) and the system area plane."""
        groups: "OrderedDict[Tuple, int]" = OrderedDict()
        tables: List[columns.TrafficTable] = []
        gidx: List[int] = []
        dps: List[DesignPoint] = []
        for dp, base in pairs:
            gkey = (dp.workload_key(), base)
            if gkey not in groups:
                groups[gkey] = len(tables)
                tables.append(self.traffic(dp, base))
            gidx.append(groups[gkey])
            dps.append(dp)
        nvms = [self._resolve_nvm(p, default=default) for p in dps]
        return columns.build_plan(tables, gidx, tuple(dps), nvms)

    # --- pricing -----------------------------------------------------------
    @staticmethod
    def _resolve_nvm(point: DesignPoint, default: str = "stt") -> str:
        return point.nvm or dev.PAPER_NVM_AT_NODE.get(point.node, default)

    def report(self, point: DesignPoint) -> EnergyReport:
        """Full per-point path: cached extraction/sizing/mapping + pricing."""
        if self._cache_reports and point in self._reports:
            self._tick("report", True)
            return self._reports[point]
        self._tick("report", False)
        base = self.base_arch(point)
        accesses = self.accesses(point, base)
        nvm = self._resolve_nvm(point)
        arch = point.placement.apply(base, default_nvm=nvm)
        rep = price(accesses, arch, point.node, point.workload_name,
                    point.variant, nvm)
        if self._cache_reports:
            self._reports[point] = rep
        return rep

    def area(self, point: DesignPoint) -> area_mod.AreaReport:
        if self._cache_reports and point in self._areas:
            self._tick("area", True)
            return self._areas[point]
        self._tick("area", False)
        base = self.base_arch(point)
        nvm = self._resolve_nvm(point, default="vgsot")
        arch = point.placement.apply(base, default_nvm=nvm)
        rep = area_mod.area(arch, point.node, point.variant)
        if self._cache_reports:
            self._areas[point] = rep
        return rep

    def evaluate_table(self, points: Iterable[DesignPoint]
                       ) -> columns.EnergyTable:
        """Columnar evaluation: price the ENTIRE space in one vectorized
        pass and return the ``EnergyTable`` (no per-point dataclasses are
        materialized — ``table.row(i)`` builds the ``EnergyReport`` view on
        demand). Bypasses the report cache; structural + plan caches carry
        all the reuse."""
        return columns.price(self.plan(points))

    def power_curves(self, points: Iterable[DesignPoint],
                     ips_grid) -> columns.PowerTable:
        """Whole Fig-5 surface for a space: memory power of every point at
        every IPS of ``ips_grid``, one vectorized shot."""
        return self.evaluate_table(points).memory_power_curves(ips_grid)

    def area_table(self, points: Iterable[DesignPoint]) -> columns.AreaTable:
        """Columnar area evaluation of the whole space (one numpy pass)."""
        return columns.area(self.plan(points, for_area=True))

    def evaluate(self, points: Iterable[DesignPoint],
                 batched: bool = True) -> "ResultSet":
        """Evaluate a space; with ``batched`` (default) the whole space is
        priced by the columnar core in one vectorized pass and the reports
        are thin row views over the ``EnergyTable``. ``batched=False`` runs
        the scalar single-point oracle per point (the parity reference)."""
        pts = list(points)
        name = getattr(points, "name", "results")
        if not batched:
            return ResultSet([(p, self.report(p)) for p in pts], name=name)
        out: Dict[DesignPoint, EnergyReport] = {}
        to_price: List[DesignPoint] = []
        for p in pts:
            if self._cache_reports and p in self._reports:
                self._tick("report", True)
                out[p] = self._reports[p]
            else:
                self._tick("report", False)
                to_price.append(p)
        if to_price:
            table = self.evaluate_table(to_price)
            for i, p in enumerate(to_price):
                rep = table.row(i)
                out[p] = rep
                if self._cache_reports:
                    self._reports[p] = rep
        return ResultSet([(p, out[p]) for p in pts], name=name)

    def areas(self, points: Iterable[DesignPoint]) -> "ResultSet":
        """Area counterpart of ``evaluate``: one columnar pass, rows are
        ``AreaReport`` views."""
        pts = list(points)
        name = getattr(points, "name", "areas")
        out: Dict[DesignPoint, area_mod.AreaReport] = {}
        to_price: List[DesignPoint] = []
        for p in pts:
            if self._cache_reports and p in self._areas:
                self._tick("area", True)
                out[p] = self._areas[p]
            else:
                self._tick("area", False)
                to_price.append(p)
        if to_price:
            table = self.area_table(to_price)
            for i, p in enumerate(to_price):
                rep = table.row(i)
                out[p] = rep
                if self._cache_reports:
                    self._areas[p] = rep
        return ResultSet([(p, out[p]) for p in pts], name=name)

    # --- system (multi-stream) plane ----------------------------------------
    def _cached_plan(self, key, build):
        """Shared LRU slot for system geometries/plans (same residency rules
        as ``plan``)."""
        hit = key in self._plans
        self._tick("plan", hit)
        if hit:
            self._plans.move_to_end(key)
        else:
            self._plans[key] = build()
            if len(self._plans) > self._plans_max:
                self._plans.popitem(last=False)
        return self._plans[key]

    def system_geometry(self, spoints) -> schedule.SystemGeometry:
        """Cached flattening of ``SystemPoint``s to per-stream plan rows
        (geometry only — survives device-table mutation)."""
        pts = tuple(spoints)
        return self._cached_plan(
            (pts, "system"), lambda: schedule.system_geometry(self, pts))

    def system_table(self, spoints) -> schedule.SystemTable:
        """Price a list of ``SystemPoint``s: one vectorized ``EnergyTable``
        pass over all (system, stream) rows + the time-multiplexing roll-up
        (``core.schedule``)."""
        return schedule.price(self.system_geometry(spoints))

    def system_area_table(self, spoints) -> columns.AreaTable:
        """Area of each system's shared (sized + placed) accelerator — one
        row per system (streams share the silicon, so any stream's geometry
        prices it)."""
        pts = tuple(spoints)

        def build():
            pairs = []
            for sp in pts:
                w_kb, a_kb, _ = schedule.system_sizing(self, sp)
                base = self.sized_arch(sp.arch, sp.pe_config, w_kb, a_kb)
                pairs.append((sp.stream_points()[0], base))
            return self.assemble_plan(pairs, default="vgsot")

        return columns.area(self._cached_plan((pts, "system_area"), build))

    def evaluate_system(self, spoints) -> "ResultSet":
        """ResultSet counterpart: (SystemPoint, SystemReport) rows."""
        tab = self.system_table(spoints)
        return ResultSet([(p, tab.row(i)) for i, p in enumerate(tab.points)],
                         name=getattr(spoints, "name", "system"))


# ---------------------------------------------------------------------------
# ResultSet
# ---------------------------------------------------------------------------

Metric = Union[str, Callable[[DesignPoint, Any], float]]


def pmem_at(ips: float) -> Callable[[DesignPoint, EnergyReport], float]:
    """Metric: average memory-subsystem power (W) at a fixed inference rate."""
    return lambda _p, r: nvm_mod.memory_power_w(r, ips)


def metric_fn(metric: Metric) -> Callable[[DesignPoint, Any], float]:
    if callable(metric):
        return metric
    return lambda _p, r: float(getattr(r, metric))


class ResultSet:
    """Ordered (DesignPoint, report) pairs with tabulation + frontier helpers."""

    def __init__(self, pairs: Sequence[Tuple[DesignPoint, Any]],
                 name: str = "results"):
        self._pairs: List[Tuple[DesignPoint, Any]] = list(pairs)
        self._by_point: Dict[DesignPoint, Any] = dict(self._pairs)
        self.name = name

    def __iter__(self):
        return iter(self._pairs)

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer, slice)):
            return self._pairs[key]
        return self._by_point[key]      # DesignPoint or SystemPoint

    def points(self) -> List[DesignPoint]:
        return [p for p, _ in self._pairs]

    def reports(self) -> List[Any]:
        return [r for _, r in self._pairs]

    # --- tabulation ---------------------------------------------------------
    @staticmethod
    def _default_row(p: DesignPoint, r: Any) -> Dict[str, Any]:
        row = dict(workload=p.workload_name, arch=p.arch, node=p.node,
                   variant=p.variant, pe_config=p.pe_config)
        if isinstance(r, EnergyReport):
            row.update(nvm=r.nvm, energy_uj=r.total_pj / 1e6,
                       mem_uj=r.mem_pj / 1e6,
                       latency_ms=r.latency_s * 1e3, edp=r.edp)
        elif isinstance(r, area_mod.AreaReport):
            row.update(nvm=p.nvm, total_mm2=r.total_mm2,
                       memory_mm2=r.memory_mm2, compute_mm2=r.compute_mm2)
        elif isinstance(r, schedule.SystemReport):
            row.update(nvm=p.nvm, mode=p.mode, ips=sum(p.ips),
                       duty=r.duty, feasible=r.feasible,
                       p_mem_w=r.p_mem_w, reload_w=r.reload_w)
        elif hasattr(r, "to_row"):      # e.g. trace.TraceReport (cycle-free)
            row.update(nvm=p.nvm, **r.to_row())
        return row

    def to_rows(self, row_fn: Optional[Callable[[DesignPoint, Any], Dict]]
                = None) -> List[Dict]:
        fn = row_fn or self._default_row
        return [fn(p, r) for p, r in self._pairs]

    def to_json(self, path: Optional[str] = None, **kw) -> str:
        text = json.dumps(self.to_rows(**kw), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    # --- slicing ------------------------------------------------------------
    def where(self, pred: Callable[[DesignPoint], bool]) -> "ResultSet":
        return ResultSet([(p, r) for p, r in self._pairs if pred(p)],
                         name=self.name)

    def groupby(self, *fields: str) -> "OrderedDict[Tuple, ResultSet]":
        groups: "OrderedDict[Tuple, List]" = OrderedDict()
        for p, r in self._pairs:
            key = tuple(getattr(p, f) for f in fields)
            groups.setdefault(key, []).append((p, r))
        return OrderedDict((k, ResultSet(v, name=f"{self.name}{list(k)}"))
                           for k, v in groups.items())

    # --- optimization helpers ----------------------------------------------
    def best(self, metric: Metric) -> Tuple[DesignPoint, Any]:
        fn = metric_fn(metric)
        return min(self._pairs, key=lambda pr: fn(*pr))

    def pareto(self, *metrics: Metric) -> "ResultSet":
        """Non-dominated subset, all metrics minimized (e.g. ``pareto('edp',
        pmem_at(10.0))`` or ``pareto('latency_s', 'total_pj')``).

        Vectorized domination test: point i is dropped iff some j is <= in
        every metric AND < in at least one (ties/duplicates all survive,
        matching the scalar definition). Candidates are processed in
        chunks so memory stays O(n * chunk * k), not O(n^2 * k)."""
        if not self._pairs:
            return ResultSet([], name=f"{self.name}:pareto")
        fns = [metric_fn(m) for m in metrics]
        v = np.array([[f(p, r) for f in fns] for p, r in self._pairs], float)
        dominated = np.zeros(len(v), bool)
        chunk = 256
        for c0 in range(0, len(v), chunk):
            vc = v[c0:c0 + chunk]                            # candidates i
            le = (v[:, None, :] <= vc[None, :, :]).all(axis=2)  # (n, c)
            lt = (v[:, None, :] < vc[None, :, :]).any(axis=2)
            dominated[c0:c0 + chunk] = (le & lt).any(axis=0)
        keep = [pr for pr, d in zip(self._pairs, dominated) if not d]
        return ResultSet(keep, name=f"{self.name}:pareto")


# ---------------------------------------------------------------------------
# The paper's sweeps as declarative spaces
# ---------------------------------------------------------------------------

_DEFAULT_EVALUATOR: Optional[Evaluator] = None


def default_evaluator() -> Evaluator:
    """Shared process-wide evaluator used by the ``dse.*`` shims.

    Reports are NOT cached (calibration tools mutate device tables between
    calls); the structural caches carry all the reuse that matters.
    """
    global _DEFAULT_EVALUATOR
    if _DEFAULT_EVALUATOR is None:
        _DEFAULT_EVALUATOR = Evaluator(cache_reports=False)
    return _DEFAULT_EVALUATOR


@dataclass(frozen=True)
class Sweep:
    """One paper figure/table: a declarative space + a row builder."""
    name: str
    figure: str
    build_space: Callable[..., DesignSpace]
    build_rows: Callable[..., List[Dict]]

    def space(self, **kw) -> DesignSpace:
        return self.build_space(**kw)

    def rows(self, evaluator: Optional[Evaluator] = None, **kw) -> List[Dict]:
        return self.build_rows(evaluator or default_evaluator(), **kw)


SYSTOLICS = ("simba", "eyeriss")
ALL_ARCHS = ("cpu", "eyeriss", "simba")
MRAM_DEVICES = ("stt", "sot", "vgsot")


# --- Fig 2(f) ---------------------------------------------------------------

def fig2f_space(workloads=PAPER_SUITE) -> DesignSpace:
    return DesignSpace.product(
        "fig2f", workload=workloads, arch=ALL_ARCHS, node=NODES_FIG2F,
        variant="sram",
    ).where(lambda p: p.node != 40 if p.arch == "cpu" else p.node != 45)


def fig2f_rows(ev: Evaluator, workloads=PAPER_SUITE) -> List[Dict]:
    rs = ev.evaluate(fig2f_space(workloads))
    return [dict(workload=p.workload_name, arch=p.arch, node=p.node,
                 energy_uj=r.total_pj / 1e6, latency_ms=r.latency_s * 1e3,
                 edp=r.edp) for p, r in rs]


# --- Fig 3(d) ---------------------------------------------------------------

def fig3d_space(workloads=PAPER_SUITE) -> DesignSpace:
    return DesignSpace.product(
        "fig3d", workload=workloads, node=PAPER_NODES, arch=ALL_ARCHS,
        variant=("sram", "p0", "p1"))


def fig3d_rows(ev: Evaluator, workloads=PAPER_SUITE) -> List[Dict]:
    rs = ev.evaluate(fig3d_space(workloads))
    return [dict(workload=p.workload_name, node=p.node, arch=p.arch,
                 variant=p.variant, nvm=r.nvm, energy_uj=r.total_pj / 1e6,
                 mem_uj=r.mem_pj / 1e6, read_uj=r.mem_read_pj / 1e6,
                 write_uj=r.mem_write_pj / 1e6,
                 compute_uj=r.compute_pj / 1e6) for p, r in rs]


# --- Fig 4 ------------------------------------------------------------------

def fig4_space(node_pairs=((28, "stt"), (7, "vgsot"))) -> DesignSpace:
    corners = tuple(Bind(node=n, nvm=d) for n, d in node_pairs)
    return DesignSpace.product(
        "fig4", workload=PAPER_SUITE, arch=ALL_ARCHS, corner=corners,
        variant=("sram", "p0", "p1"))


def fig4_rows(ev: Evaluator,
              node_pairs=((28, "stt"), (7, "vgsot"))) -> List[Dict]:
    rs = ev.evaluate(fig4_space(node_pairs))
    return [dict(workload=p.workload_name, arch=p.arch, node=p.node,
                 variant=p.variant, device=p.nvm,
                 read_uj=r.mem_read_pj / 1e6, write_uj=r.mem_write_pj / 1e6,
                 compute_uj=r.compute_pj / 1e6) for p, r in rs]


# --- Fig 5 ------------------------------------------------------------------

def fig5_space(workloads=PAPER_SUITE, node: int = 7) -> DesignSpace:
    base = DesignSpace.product(
        "fig5:sram", workload=workloads, arch=SYSTOLICS, node=node,
        variant="sram")
    mram = DesignSpace.product(
        "fig5:mram", workload=workloads, arch=SYSTOLICS, variant=("p1", "p0"),
        nvm=MRAM_DEVICES, node=node)
    return base + mram


def fig5_rows(ev: Evaluator, workloads=PAPER_SUITE, node: int = 7,
              n_points: int = 25) -> List[Dict]:
    """Whole-figure columnar path: ONE ``EnergyTable`` for the space, ONE
    (points x IPS-grid) power surface, and every cross-over via batched
    bisection — no per-(point, ips) scalar calls."""
    if n_points < 2:
        raise ValueError("fig5_rows needs n_points >= 2 for the IPS grid")
    space = fig5_space(workloads, node)
    pts = list(space)
    table = ev.evaluate_table(space)
    mram, pair_s = nvm_mod.sram_pairs(pts)
    xo = nvm_mod.crossover_ips_batch(table, mram, pair_s)
    ips_grid = 10 ** (-2 + 4 * np.arange(n_points) / (n_points - 1))
    power = nvm_mod.memory_power_curves(table, ips_grid)
    rows = []
    for k, i in enumerate(mram):
        p = pts[i]
        xval = None if math.isnan(xo[k]) else float(xo[k])
        for g in range(n_points):
            ips = float(ips_grid[g])
            if ips > table.max_ips[i]:
                break
            rows.append(dict(
                workload=p.workload_name, arch=p.arch, variant=p.variant,
                device=p.nvm, ips=ips,
                p_mem_w=float(power.p_mem_w[i, g]),
                p_sram_w=float(power.p_mem_w[pair_s[k], g]),
                crossover_ips=xval))
    return rows


# --- Table 2 ----------------------------------------------------------------

def table2_space(workloads=PAPER_SUITE, node: int = 7) -> DesignSpace:
    return DesignSpace.product(
        "table2", arch=SYSTOLICS, variant=("sram", "p0", "p1"),
        workload=workloads[0], node=node, nvm="vgsot",
        suite=[tuple(workloads)])


def table2_rows(ev: Evaluator, workloads=PAPER_SUITE,
                node: int = 7) -> List[Dict]:
    rs = ev.areas(table2_space(workloads, node))
    rows = []
    for (arch,), group in rs.groupby("arch").items():
        reps = {p.variant: r for p, r in group}
        rows.append(dict(
            arch=arch,
            sram_mm2=reps["sram"].total_mm2,
            p0_mm2=reps["p0"].total_mm2,
            p1_mm2=reps["p1"].total_mm2,
            p0_savings=area_mod.savings(reps["p0"], reps["sram"]),
            p1_savings=area_mod.savings(reps["p1"], reps["sram"])))
    return rows


# --- Table 3 ----------------------------------------------------------------

def table3_space(node: int = 7) -> DesignSpace:
    return DesignSpace.product(
        "table3", workload=PAPER_SUITE, arch=SYSTOLICS,
        variant=("sram", "p0", "p1"), node=node)


def table3_rows(ev: Evaluator, node: int = 7) -> List[Dict]:
    rs = ev.evaluate(table3_space(node))
    rows = []
    for (w, a), group in rs.groupby("workload", "arch").items():
        w = group.points()[0].workload_name
        reps = {p.variant: r for p, r in group}
        ips = IPS_MIN[w]
        out = dict(workload=w, arch=a, ips=ips)
        for v in ("p0", "p1"):
            out[f"{v}_latency_ms"] = reps[v].latency_s * 1e3
            out[f"{v}_savings"] = nvm_mod.savings_at_ips(
                reps[v], reps["sram"], ips)
        out["sram_latency_ms"] = reps["sram"].latency_s * 1e3
        rows.append(out)
    return rows


# --- beyond-paper: edge-LM KV-cache DSE -------------------------------------

def lm_kv_space(arch_names=SYSTOLICS, node: int = 7,
                context_len: int = 4096,
                archs=("llama3.2-1b",)) -> DesignSpace:
    kw = (("context_len", context_len),)
    base = DesignSpace.product(
        "lm_kv:sram", workload=archs, arch=arch_names, node=node,
        variant="sram", extract_kw=[kw], suite=[None])
    mram = DesignSpace.product(
        "lm_kv:mram", workload=archs, arch=arch_names, variant=("p0", "p1"),
        nvm=MRAM_DEVICES, node=node, extract_kw=[kw], suite=[None])
    return base + mram


def lm_kv_rows(ev: Evaluator, arch_names=SYSTOLICS, node: int = 7,
               context_len: int = 4096,
               archs=("llama3.2-1b",)) -> List[Dict]:
    rs = ev.evaluate(lm_kv_space(arch_names, node, context_len, archs))
    sram = {(p.workload, p.arch): r for p, r in rs if p.variant == "sram"}
    rows = []
    for p, r in rs:
        if p.variant == "sram":
            continue
        s = sram[(p.workload, p.arch)]
        # savings are evaluated at 10 tok/s OR the pipeline's max rate,
        # whichever is lower — report the rate actually used instead of
        # mislabeling the column as always-10-tok/s.
        savings_ips = min(10.0, r.max_ips)
        rows.append(dict(
            model=p.workload, arch=p.arch, variant=p.variant, device=p.nvm,
            energy_mj=r.total_pj / 1e9,
            latency_ms=r.latency_s * 1e3,
            crossover_tok_s=nvm_mod.crossover_ips(r, s),
            savings_ips=savings_ips,
            savings_at_ips=nvm_mod.savings_at_ips(r, s, savings_ips)))
    return rows


# --- beyond-paper: mixed-precision (quantization) DSE ------------------------

# The paper's first analysis step is quantization; these corners extend it
# into a design-space axis. Each corner must agree with what the jax plane's
# PTQ actually emits (``quant/ptq.py`` with ``bits=weight_bits`` /
# ``bits=act_bits``) — the plane-agreement test in tests/test_quant_axis.py
# ties the two. ``w4a8`` is weight-ONLY quantization: on LM decode specs the
# KV cache is weight-class, so this corner is exactly the INT4-KV-cache
# read-mostly scenario the P0 question targets.
QUANT_CORNERS = (
    Bind(weight_bits=8, act_bits=8),    # int8: the paper's baseline
    Bind(weight_bits=4, act_bits=8),    # w4a8: weight-only (incl. KV cache)
    Bind(weight_bits=4, act_bits=4),    # int4: fully quantized
)

# Engines swept on the precision axis: the paper's systolic platforms are
# memory-bound on the XR suite (lane splitting never moves their latency),
# so the sweep also carries the COMPUTE-bound sequential engines — the CPU
# (1D 64-bit SIMD) and the XR-NPE-style 2D mixed-precision coprocessor
# (PAPERS.md) — where the compute plane sets latency and the low-precision
# throughput/energy wins are superlinear. First two entries must stay
# SYSTOLICS: the original 54-row sweep is a frozen byte-identity oracle.
QUANT_ENGINES = SYSTOLICS + ("cpu", "xr-npe")


def quant_space(workloads=PAPER_SUITE, node: int = 7,
                context_len: int = 4096,
                lm_archs=("llama3.2-1b",),
                corners=QUANT_CORNERS,
                engines=QUANT_ENGINES) -> DesignSpace:
    """Precision x variant space: XR suite + LM KV-cache workloads at every
    quantization corner, SRAM baseline plus both MRAM placements."""
    xr = DesignSpace.product(
        "quant:xr", workload=workloads, arch=engines,
        variant=("sram", "p0", "p1"), node=node, precision=corners)
    kw = (("context_len", context_len),)
    lm = DesignSpace.product(
        "quant:lm", workload=lm_archs, arch=SYSTOLICS,
        variant=("sram", "p0", "p1"), node=node, precision=corners,
        extract_kw=[kw], suite=[None])
    return xr + lm


def quant_rows(ev: Evaluator, workloads=PAPER_SUITE, node: int = 7,
               context_len: int = 4096,
               lm_archs=("llama3.2-1b",),
               engines=QUANT_ENGINES) -> List[Dict]:
    """How precision shifts the SRAM-vs-MRAM trade-off: energy, latency,
    area and the MRAM cross-over IPS per (workload, engine, corner) —
    including the compute-bound sequential engines where lane splitting
    moves latency, not just storage energy.

    Columnar end to end: one ``EnergyTable`` + one ``AreaTable`` for the
    whole space, cross-overs via batched bisection against the SAME-corner
    SRAM baseline (``sram_pairs`` keys include the operand widths)."""
    space = quant_space(workloads, node, context_len, lm_archs, engines=engines)
    pts = list(space)
    table = ev.evaluate_table(space)
    areas = ev.area_table(space)
    mram, pair_s = nvm_mod.sram_pairs(pts)
    xo = nvm_mod.crossover_ips_batch(table, mram, pair_s)
    xo_at = {i: xo[k] for k, i in enumerate(mram)}
    rows = []
    for i, p in enumerate(pts):
        x = xo_at.get(i)
        rows.append(dict(
            workload=p.workload_name, arch=p.arch, variant=p.variant,
            device=table.plan.nvms[i] if p.variant != "sram" else None,
            precision=p.precision_label,
            weight_bits=p.weight_bits, act_bits=p.act_bits,
            energy_uj=float(table.total_pj[i]) / 1e6,
            mem_uj=float(table.mem_pj[i]) / 1e6,
            latency_ms=float(table.latency_s[i]) * 1e3,
            max_ips=float(table.max_ips[i]),
            total_mm2=float(areas.total_mm2[i]),
            crossover_ips=(None if x is None or math.isnan(x)
                           else float(x))))
    return rows


# --- beyond-paper: per-level placement lattice (hybrid hierarchies) ---------

# The lattice's technology menu: the paper's three MRAM devices plus SRAM.
# 4 techs over Simba's 4 levels = 256 hierarchies per (workload, node).
PLACEMENT_TECHS = ("sram", "stt", "sot", "vgsot")


def placement_space(workloads=PAPER_SUITE, arch: str = "simba",
                    node: int = 7, techs=PLACEMENT_TECHS,
                    levels=None) -> DesignSpace:
    """The full per-level technology lattice for one architecture: every
    assignment of ``techs`` to ``levels`` (default: the whole hierarchy),
    as ONE declarative space — the paper's 2-point {P0, P1} axis
    generalized to ``len(techs) ** len(levels)`` hierarchies."""
    placements = tuple(Placement.enumerate(arch, tuple(techs), levels=levels))
    return DesignSpace.product(
        "placement", workload=workloads, arch=arch, node=node,
        placement=placements)


def placement_rows(ev: Evaluator, workloads=PAPER_SUITE, arch: str = "simba",
                   node: int = 7, techs=PLACEMENT_TECHS, levels=None,
                   ips: Optional[float] = None) -> List[Dict]:
    """Price the WHOLE placement lattice in one columnar pass and report,
    per (workload, placement): memory power at the paper's IPS target,
    savings vs the all-SRAM baseline, the same-placement cross-over IPS
    (batched bisection vs that baseline), area, and whether the hierarchy
    beats the paper's P0/P1 corners and sits on the (P_mem, area) Pareto
    frontier of its workload group.

    The corners (all-SRAM, P0, P1 at the node's paper device) are APPENDED
    to the priced point list rather than located inside the lattice, so
    any sub-lattice works too (``levels=('gwb',)``, ``techs`` without
    'sram', ...) — the comparison baseline never depends on lattice
    membership."""
    space = placement_space(workloads, arch, node, techs, levels)
    pts = list(space)
    # paper corners per (workload, node), priced in the SAME pass
    corners: Dict[Tuple, Dict[str, int]] = {}
    corner_pts: List[DesignPoint] = []
    for p in pts:
        key = (p.workload_name, p.node)
        if key in corners:
            continue
        nvm = dev.PAPER_NVM_AT_NODE.get(p.node, "stt")
        corners[key] = {}
        for v in ("sram", "p0", "p1"):
            corners[key][v] = len(pts) + len(corner_pts)
            corner_pts.append(p.with_(placement=Placement.variant(v, nvm)))
    all_pts = pts + corner_pts
    table = ev.evaluate_table(all_pts)        # ONE vectorized pricing pass
    areas = ev.area_table(space)
    plan = table.plan
    techs_by_row = [tuple(str(plan.tech_names[i, j])
                          for j in range(plan.mask.shape[1])
                          if plan.mask[i, j]) for i in range(len(pts))]
    level_names = [str(n) for n, m in zip(plan.level_names[0], plan.mask[0])
                   if m]

    ips_pp = np.array([ips if ips is not None
                       else IPS_MIN.get(p.workload_name, 10.0)
                       for p in all_pts])
    pmem = table.memory_power_at(ips_pp)

    base_rows = np.array([corners[(p.workload_name, p.node)]["sram"]
                          for p in pts], int)
    hybrid = [i for i, p in enumerate(pts)
              if not p.placement.converts_nothing]
    xo = nvm_mod.crossover_ips_batch(table, hybrid, base_rows[hybrid])
    xo_at = {i: xo[k] for k, i in enumerate(hybrid)}

    # Pareto on (P_mem@target, total area) within each (workload, node) group
    pareto = np.zeros(len(pts), bool)
    for key in corners:
        idx = np.array([i for i, p in enumerate(pts)
                        if (p.workload_name, p.node) == key], int)
        v = np.stack([pmem[idx], areas.total_mm2[idx]], axis=1)
        le = (v[:, None, :] <= v[None, :, :]).all(axis=2)
        lt = (v[:, None, :] < v[None, :, :]).any(axis=2)
        pareto[idx] = ~(le & lt).any(axis=0)

    rows = []
    for i, p in enumerate(pts):
        c = corners[(p.workload_name, p.node)]
        x = xo_at.get(i)
        rows.append(dict(
            workload=p.workload_name, arch=p.arch, node=p.node,
            placement=p.variant,
            techs=dict(zip(level_names, techs_by_row[i])),
            ips=float(ips_pp[i]),
            p_mem_w=float(pmem[i]),
            savings=float(1.0 - pmem[i] / pmem[base_rows[i]]),
            crossover_ips=(None if x is None or math.isnan(x) else float(x)),
            total_mm2=float(areas.total_mm2[i]),
            p0_p_mem_w=float(pmem[c["p0"]]),
            p1_p_mem_w=float(pmem[c["p1"]]),
            beats_p0=bool(pmem[i] < pmem[c["p0"]]),
            beats_p1=bool(pmem[i] < pmem[c["p1"]]),
            pareto=bool(pareto[i])))
    return rows


# --- beyond-paper: multi-stream system plane (concurrent workloads) ---------

# The paper's two applications as ONE time-shared system: hand detection at
# its minimum rate plus eye segmentation at its minimum rate, on a single
# accelerator (DESIGN.md §7 §System).
XR_BUNDLE = (schedule.Stream("detnet", IPS_MIN["detnet"]),
             schedule.Stream("edsnet", IPS_MIN["edsnet"]))


class SystemSpace(list):
    """A list of ``SystemPoint``s with a DesignSpace-style repr/name
    (``DesignSpace`` itself is DesignPoint-typed; system points carry their
    own stream axis, so the system sweeps stay plain point lists)."""

    def __init__(self, points, name: str = "system"):
        super().__init__(points)
        self.name = name

    def __repr__(self):
        return f"SystemSpace({self.name!r}, {len(self)} systems)"


def system_space(streams=XR_BUNDLE, arch: str = "simba", node: int = 7,
                 techs=PLACEMENT_TECHS, levels=None,
                 mode: str = "reload") -> SystemSpace:
    """The stream bundle across the per-level technology lattice: one
    ``SystemPoint`` per placement, all sharing (arch, node, mode)."""
    streams = tuple(streams)
    pls = Placement.enumerate(arch, tuple(techs), levels=levels)
    return SystemSpace(
        [schedule.SystemPoint(streams, arch, node, placement=pl, mode=mode)
         for pl in pls],
        name=f"system:{'+'.join(s.name for s in streams)}")


def system_rows(ev: Evaluator, streams=XR_BUNDLE, arch: str = "simba",
                node: int = 7, techs=PLACEMENT_TECHS, levels=None,
                mode: str = "reload") -> List[Dict]:
    """Price the stream bundle across the placement lattice and report, per
    placement: system memory power, feasibility (sum of duties), savings vs
    the all-SRAM SYSTEM baseline, the reload share, the shared-silicon
    area, and — the system-level claim — each placement's own SINGLE-stream
    savings, so the rows show where time-sharing beats the paper's
    isolated-pipeline analysis (reload + shared-standby elimination are
    only visible at system level).

    Everything is priced in ONE pass: lattice systems, the paper-corner
    systems (sram/p0/p1, appended like ``placement_rows`` does), and the
    per-stream single-stream systems used for the comparison baselines."""
    space = system_space(streams, arch, node, techs, levels, mode)
    pts = list(space)
    streams = tuple(streams)
    nvm = dev.PAPER_NVM_AT_NODE.get(node, "stt")
    corner_pls = {v: Placement.variant(v, nvm) for v in ("sram", "p0", "p1")}
    corner_at = {}
    corner_pts = []
    for v, pl in corner_pls.items():
        corner_at[v] = len(pts) + len(corner_pts)
        corner_pts.append(pts[0].with_(placement=pl))
    sys_pts = pts + corner_pts
    # single-stream systems for every placement (lattice + corners): the
    # per-stream baselines the system savings are compared against
    single_at: Dict[Tuple[int, int], int] = {}
    single_pts = []
    for i, p in enumerate(sys_pts):
        for k, s in enumerate(streams):
            single_at[(i, k)] = len(sys_pts) + len(single_pts)
            single_pts.append(p.with_(streams=(s,)))
    all_pts = sys_pts + single_pts
    tab = ev.system_table(all_pts)              # ONE vectorized pricing pass
    areas = ev.system_area_table(sys_pts)
    pm = tab.p_mem_w
    sram_i = corner_at["sram"]

    def single_savings(i: int, k: int) -> float:
        return 1.0 - (pm[single_at[(i, k)]] / pm[single_at[(sram_i, k)]])

    rows = []
    for i, p in enumerate(sys_pts):
        singles = {s.name: float(single_savings(i, k))
                   for k, s in enumerate(streams)}
        best_single = max(singles.values())
        savings = float(1.0 - pm[i] / pm[sram_i])
        rows.append(dict(
            workloads=p.workload_name, arch=p.arch, node=p.node, mode=p.mode,
            placement=p.variant,
            ips=dict((s.name, s.ips) for s in streams),
            duty=float(tab.duty[i]), feasible=bool(tab.feasible[i]),
            p_mem_w=float(pm[i]), sram_p_mem_w=float(pm[sram_i]),
            savings=savings,
            reload_uw=float(tab.reload_w[i]) * 1e6,
            single_savings=singles,
            best_single_savings=float(best_single),
            beats_single=bool(savings > best_single),
            beats_p0=bool(pm[i] < pm[corner_at["p0"]]),
            beats_p1=bool(pm[i] < pm[corner_at["p1"]]),
            total_mm2=float(areas.total_mm2[i])))
    return rows


SWEEPS: Dict[str, Sweep] = {
    "fig2f": Sweep("fig2f", "Fig 2(f): EDP vs node, SRAM-only platforms",
                   fig2f_space, fig2f_rows),
    "fig3d": Sweep("fig3d", "Fig 3(d): 9 variants x {28,7}nm energy",
                   fig3d_space, fig3d_rows),
    "fig4": Sweep("fig4", "Fig 4: read/write/compute breakdown per variant",
                  fig4_space, fig4_rows),
    "fig5": Sweep("fig5", "Fig 5: memory power vs IPS, 4 devices, P0/P1",
                  fig5_space, fig5_rows),
    "table2": Sweep("table2", "Table 2: area at 7nm, SRAM vs P0 vs P1",
                    table2_space, table2_rows),
    "table3": Sweep("table3", "Table 3: P_mem savings + latency at IPS_min",
                    table3_space, table3_rows),
    "lm_kv": Sweep("lm_kv", "Beyond-paper: edge-LM KV-cache MRAM DSE",
                   lm_kv_space, lm_kv_rows),
    "quant": Sweep("quant", "Beyond-paper: precision axis (INT8/W4A8/INT4) "
                   "energy/latency/area + MRAM cross-over",
                   quant_space, quant_rows),
    "placement": Sweep("placement", "Beyond-paper: per-level technology "
                       "lattice — hybrid hierarchies vs the P0/P1 corners",
                       placement_space, placement_rows),
    "system": Sweep("system", "Beyond-paper: multi-stream XR system — "
                    "concurrent workloads time-shared on one accelerator",
                    system_space, system_rows),
}
