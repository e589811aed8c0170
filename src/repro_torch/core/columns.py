"""Columnar (struct-of-arrays) pricing core: whole design spaces in one pass.

Batching only the final pricing step would leave everything upstream
building Python object lists per point (``LayerAccess`` lists, ``EnergyReport`` /
``LevelEnergy`` dataclasses, per-point ``memory_power_w`` calls). This
module tensorizes the dataflow -> energy -> NVM -> area roll-up:

  * ``TrafficTable``  — one mapped (workload, sized-arch) group as named
    (layer x level) numpy arrays. Built from legacy ``LayerAccess`` rows
    (``from_accesses``) or directly by the vectorized mappers
    (``map_specs``, all layers of a workload in array ops).
  * ``PricingPlan``   — a whole ``DesignSpace`` flattened to (point x level)
    geometry arrays: traffic, macro sizes, bus widths, resolved technology
    codes. Pure *structure*: no device constants are baked in, so
    calibration tools may mutate ``core.devices`` between pricings and
    reuse a cached plan (the gridsearch hot loop).
  * ``EnergyTable``   — every per-point / per-level energy, power and
    latency column priced in a single vectorized pass (``price``);
    ``row(i)`` materializes the scalar ``EnergyReport`` view.
  * ``PowerTable``    — memory-power-vs-IPS curves for every point over a
    shared IPS grid in one shot (whole Fig-5 sweeps per call), plus the
    batched-bisection ``crossover_ips``.
  * ``AreaTable``     — CACTI-lite area columns (``area``); ``row(i)``
    materializes the scalar ``AreaReport`` view.

Formulas are kept identical to the scalar oracles in ``core.energy`` /
``core.nvm`` / ``core.area`` — those modules stay the single-point reference
implementations, and the parity suite (``tests/test_space.py`` /
``tests/test_columns.py``) holds every columnar row to <=1e-9 of them.

Level axes are padded to the widest architecture in the space (``mask``
marks real levels); padded cells carry zero traffic/capacity so they price
to zero without branches.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ConvLayerSpec
from repro_torch.core import area as area_mod
from repro_torch.core import dataflow as dfl
from repro_torch.core import devices as dev
from repro_torch.core.archspec import ArchSpec
from repro_torch.core.dataflow import LayerAccess, LevelTraffic
from repro_torch.core.energy import EnergyReport, LevelEnergy
from repro_torch.core.placement import Placement


def freeze_arrays(obj) -> None:
    """Mark every ndarray field of a dataclass instance read-only.

    Column tables are memoized by the Evaluator / LatticePricer and the
    cached instance is returned to every caller by reference (defensive
    copies would defeat the point of the structural caches). Freezing the
    arrays at construction makes accidental in-place mutation of shared
    state a loud ``ValueError`` instead of silent cross-caller corruption
    — the runtime half of the MU checker's static guarantee. Callers that
    legitimately need a scratch column must ``.copy()`` it.
    """
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            v.setflags(write=False)


# ---------------------------------------------------------------------------
# TrafficTable: one (workload, sized arch) mapping as (layer x level) arrays
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrafficTable:
    """Access counts of one workload on one sized arch, columnar.

    ``read_bits``/``write_bits`` are (layers, levels); the legacy
    ``LayerAccess`` dataclass is a row view (``row(i)``), and the
    workload-level aggregates the scalar path computed with
    ``total_traffic`` are column sums.
    """
    arch: ArchSpec
    layer_names: Tuple[str, ...]
    level_names: Tuple[str, ...]
    level_cls: Tuple[str, ...]
    macro_kb: np.ndarray        # (L,)
    capacity_kb: np.ndarray     # (L,)
    bus_bits: np.ndarray        # (L,)
    count: np.ndarray           # (L,) banks per level
    read_bits: np.ndarray       # (N, L)
    write_bits: np.ndarray      # (N, L)
    macs: np.ndarray            # (N,)
    delivery_macs: np.ndarray   # (N,)
    compute_cycles: np.ndarray  # (N,)
    weight_bits: np.ndarray     # (N,) per-layer operand widths the mapping
    act_bits: np.ndarray        # (N,) was priced at (compute plane)

    def __post_init__(self) -> None:
        freeze_arrays(self)

    # --- construction -------------------------------------------------------
    @classmethod
    def _empty(cls, arch: ArchSpec, n_layers: int, layer_names) -> Dict:
        lv = arch.levels
        return dict(
            arch=arch,
            layer_names=tuple(layer_names),
            level_names=tuple(l.name for l in lv),
            level_cls=tuple(l.cls for l in lv),
            macro_kb=np.array([l.macro_kb for l in lv], float),
            capacity_kb=np.array([l.capacity_kb for l in lv], float),
            bus_bits=np.array([float(l.bus_bits) for l in lv]),
            count=np.array([float(l.count) for l in lv]),
            read_bits=np.zeros((n_layers, len(lv))),
            write_bits=np.zeros((n_layers, len(lv))),
            macs=np.zeros(n_layers),
            delivery_macs=np.zeros(n_layers),
            compute_cycles=np.zeros(n_layers),
            weight_bits=np.full(n_layers, 8.0),
            act_bits=np.full(n_layers, 8.0),
        )

    @classmethod
    def from_accesses(cls, accesses: Sequence[LayerAccess],
                      arch: ArchSpec) -> "TrafficTable":
        """Convert legacy per-layer ``LayerAccess`` rows to columns."""
        kw = cls._empty(arch, len(accesses), [a.name for a in accesses])
        idx = {n: j for j, n in enumerate(kw["level_names"])}
        for i, a in enumerate(accesses):
            for name, tr in a.traffic.items():
                kw["read_bits"][i, idx[name]] = tr.read_bits
                kw["write_bits"][i, idx[name]] = tr.write_bits
            kw["macs"][i] = a.macs
            kw["delivery_macs"][i] = a.delivery_macs
            kw["compute_cycles"][i] = a.compute_cycles
            kw["weight_bits"][i] = a.weight_bits
            kw["act_bits"][i] = a.act_bits
        return cls(**kw)

    @classmethod
    def map_specs(cls, specs: Sequence[ConvLayerSpec],
                  arch: ArchSpec) -> "TrafficTable":
        """Vectorized Timeloop-lite: map all layers of a workload in array
        ops (same formulas as the scalar mappers in ``core.dataflow``)."""
        kw = cls._empty(arch, len(specs), [s.name for s in specs])
        col = {n: j for j, n in enumerate(kw["level_names"])}
        # per-layer operand widths (mixed precision: each layer prices its
        # operands at their stored width, matching the scalar mappers)
        wbits = np.array([s.weight_bits for s in specs], float)
        abits = np.array([s.act_bits for s in specs], float)
        pbits = np.array([s.psum_width for s in specs], float)
        W = np.array([s.weight_elems for s in specs], float) * wbits
        I = np.array([s.in_elems for s in specs], float) * abits
        O = np.array([s.out_elems for s in specs], float)
        macs = np.array([s.macs for s in specs], float)
        # per-layer SIMD lane split of the arch's compute archetype (exactly
        # 1.0 at int8: num_pes * 1.0 == float(num_pes), so int8 cycles are
        # bit-identical to the fixed-datapath model)
        split = arch.compute.macs_per_pe_per_cycle(wbits, abits)
        is_dw = np.array([s.kind == "dwconv" for s in specs])
        out_ch = np.array([s.out_ch for s in specs], float)
        in_bytes = np.array([s.in_bytes for s in specs], float)
        rb, wb = kw["read_bits"], kw["write_bits"]

        def refetch(cap_kb: float) -> np.ndarray:
            return np.maximum(
                1.0, np.ceil(in_bytes / 1024.0 / max(cap_kb, 1.0)))

        if arch.dataflow == "sequential":
            rb[:, col["weight_mem"]] = W
            rb[:, col["act_mem"]] = I
            wb[:, col["act_mem"]] = O * abits
            kw["compute_cycles"] = macs / (dfl.CPU_SIMD * split)
        elif arch.dataflow == "weight":
            wb_bits = arch.level("pe_wb").capacity_bits
            n_wtiles = np.maximum(1.0, np.ceil(W / wb_bits))
            resident = n_wtiles == 1
            n_kpasses = np.where(
                is_dw, 1.0, np.maximum(1.0, np.ceil(out_ch / arch.pe_x)))
            red = np.where(
                is_dw, 1.0,
                np.array([s.in_ch * s.kernel * s.kernel for s in specs],
                         float))
            n_ctiles = np.maximum(1.0, np.ceil(red / arch.pe_x))
            rf = refetch(arch.level("input_buf").capacity_kb)
            rb[:, col["gwb"]] = np.where(resident, 0.0, W)
            wb[:, col["pe_wb"]] = np.where(resident, 0.0, W)
            rb[:, col["pe_wb"]] = W
            wb[:, col["input_buf"]] = I * rf
            rb[:, col["input_buf"]] = I * np.maximum(n_wtiles, n_kpasses) * rf
            wb[:, col["accum_buf"]] = O * pbits * n_ctiles
            rb[:, col["accum_buf"]] = O * pbits * n_ctiles
            kw["compute_cycles"] = macs / (arch.num_pes * split)
        elif arch.dataflow == "row":
            oh = np.array([s.out_hw[0] for s in specs], float)
            k = np.array([s.kernel for s in specs], int)
            n_strips = np.maximum(1.0, np.ceil(oh / arch.pe_y))
            k_par = np.maximum(1, arch.pe_x // np.maximum(1, k))
            n_ktiles = np.maximum(1.0, np.ceil(out_ch / k_par))
            rf = refetch(arch.level("glb").capacity_kb)
            rb[:, col["gwb"]] = W * n_strips
            wb[:, col["pe_spad"]] = W * n_strips
            rb[:, col["pe_spad"]] = macs * wbits
            wb[:, col["glb"]] = I * rf + O * pbits
            rb[:, col["glb"]] = I * n_ktiles * rf
            kw["compute_cycles"] = macs / (arch.num_pes * split)
        else:
            raise ValueError(arch.dataflow)
        kw["macs"] = macs
        kw["delivery_macs"] = macs
        kw["weight_bits"] = wbits
        kw["act_bits"] = abits
        return cls(**kw)

    # --- aggregates / views -------------------------------------------------
    @property
    def num_layers(self) -> int:
        return self.read_bits.shape[0]

    @property
    def num_levels(self) -> int:
        return self.read_bits.shape[1]

    @property
    def total_read_bits(self) -> np.ndarray:     # (L,)
        return self.read_bits.sum(axis=0)

    @property
    def total_write_bits(self) -> np.ndarray:    # (L,)
        return self.write_bits.sum(axis=0)

    @property
    def total_macs(self) -> int:
        return int(self.macs.sum())

    @property
    def total_delivery_macs(self) -> int:
        return int(self.delivery_macs.sum())

    @property
    def total_compute_cycles(self) -> float:
        return float(self.compute_cycles.sum())

    # --- compute-plane group scalars (DESIGN.md §10) ------------------------
    # MACs-weighted means over the layers; combined with the module-level
    # energy constants at PRICE time (plans stay device-constant-free).
    # Each is exactly its int8 anchor value (0.0 / 1.0 / 0.0) when every
    # layer is int8, which is what keeps int8 pricing bit-identical.
    @property
    def mul_frac(self) -> float:
        """Excess multiplier bit-work per MAC vs INT8 (0.0 at the anchor)."""
        total = self.macs.sum()
        if total == 0.0:
            return 0.0
        return float((self.macs * dev.mac_mul_units(
            self.weight_bits, self.act_bits)).sum() / total)

    @property
    def issue_ratio(self) -> float:
        """Issue slots per MAC: 1/lane-split, MACs-weighted (1.0 at int8)."""
        total = self.macs.sum()
        if total == 0.0:
            return 1.0
        split = self.arch.compute.macs_per_pe_per_cycle(self.weight_bits,
                                                        self.act_bits)
        return float((self.macs / split).sum() / total)

    @property
    def dlvw_frac(self) -> float:
        """Excess operand-pair delivery width per MAC vs INT8 (0.0 at the
        anchor)."""
        total = self.delivery_macs.sum()
        if total == 0.0:
            return 0.0
        return float((self.delivery_macs * dev.delivery_width_units(
            self.weight_bits, self.act_bits)).sum() / total)

    def aggregate(self) -> Dict[str, LevelTraffic]:
        """Workload totals in the legacy ``total_traffic`` shape."""
        r, w = self.total_read_bits, self.total_write_bits
        return {n: LevelTraffic(float(r[j]), float(w[j]))
                for j, n in enumerate(self.level_names)}

    def row(self, i: int) -> LayerAccess:
        """Legacy per-layer dataclass as a row view."""
        traffic = {n: LevelTraffic(float(self.read_bits[i, j]),
                                   float(self.write_bits[i, j]))
                   for j, n in enumerate(self.level_names)}
        return LayerAccess(self.layer_names[i], int(self.macs[i]), traffic,
                           float(self.compute_cycles[i]),
                           int(self.delivery_macs[i]),
                           int(self.weight_bits[i]), int(self.act_bits[i]))


# ---------------------------------------------------------------------------
# PricingPlan: a whole space flattened to (point x level) geometry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PricingPlan:
    """Device-constant-free flattening of (points, mapped traffic groups).

    Everything here is geometry + names: re-pricing after a device-table
    mutation reuses the plan untouched (``core.devices`` is re-read on every
    ``price``/``area`` call).
    """
    points: Tuple[Any, ...]              # DesignPoints (opaque here)
    groups: Tuple[TrafficTable, ...]
    gidx: np.ndarray                     # (P,) point -> group
    # per-point metadata
    workloads: Tuple[str, ...]
    arch_names: Tuple[str, ...]
    variants: Tuple[str, ...]
    nvms: Tuple[str, ...]
    nodes: Tuple[int, ...]
    node_list: Tuple[int, ...]
    node_idx: np.ndarray                 # (P,) -> node_list
    clock_keys: Tuple[Tuple[int, str], ...]
    clock_idx: np.ndarray                # (P,) -> clock_keys
    is_cpu: np.ndarray                   # (P,) bool
    num_pes: np.ndarray                  # (P,)
    macs: np.ndarray                     # (P,)
    delivery_macs: np.ndarray            # (P,)
    compute_cycles: np.ndarray           # (P,)
    # compute-plane geometry (dimensionless, MACs-weighted; exactly
    # 0.0 / 1.0 / 0.0 at the int8 anchor — TrafficTable.mul_frac et al.)
    mul_frac: np.ndarray                 # (P,)
    issue_ratio: np.ndarray              # (P,)
    dlvw_frac: np.ndarray                # (P,)
    # per-(point, level) geometry, padded to the widest arch
    mask: np.ndarray                     # (P, L) bool: real level
    level_names: np.ndarray              # (P, L) object
    level_cls: np.ndarray                # (P, L) object
    weight_cls: np.ndarray               # (P, L) bool
    macro_kb: np.ndarray                 # (P, L) padded 1.0
    capacity_kb: np.ndarray              # (P, L) padded 0.0
    bus_bits: np.ndarray                 # (P, L) padded 1.0
    count: np.ndarray                    # (P, L) padded 0.0
    read_bits: np.ndarray                # (P, L) padded 0.0
    write_bits: np.ndarray               # (P, L) padded 0.0
    tech_names: np.ndarray               # (P, L) object, variant-resolved
    tech_list: Tuple[str, ...]
    tech_idx: np.ndarray                 # (P, L) -> tech_list

    def __post_init__(self) -> None:
        freeze_arrays(self)

    @property
    def n_points(self) -> int:
        return len(self.points)


def group_geometry(groups: Sequence[TrafficTable]) -> Dict[str, np.ndarray]:
    """Per-GROUP geometry padded to the widest arch in ``groups`` — the
    (G, Lmax) half of plan assembly, shared by ``build_plan`` and the
    JAX package's streaming lattice pricer, which gathers these rows per
    chunk instead of re-deriving them per point."""
    G = len(groups)
    Lmax = max((t.num_levels for t in groups), default=0)

    def pad(values_per_group, fill, dtype=float):
        out = np.full((G, Lmax), fill, dtype=dtype)
        for g, vals in enumerate(values_per_group):
            out[g, :len(vals)] = vals
        return out

    return dict(
        mask=pad([[True] * t.num_levels for t in groups], False, bool),
        names=pad([t.level_names for t in groups], "", object),
        cls=pad([t.level_cls for t in groups], "", object),
        macro=pad([t.macro_kb for t in groups], 1.0),
        cap=pad([t.capacity_kb for t in groups], 0.0),
        bus=pad([t.bus_bits for t in groups], 1.0),
        count=pad([t.count for t in groups], 0.0),
        read=pad([t.total_read_bits for t in groups], 0.0),
        write=pad([t.total_write_bits for t in groups], 0.0),
        tech=pad([[l.tech for l in t.arch.levels] for t in groups],
                 "sram", object),
        is_cpu=np.array([t.arch.dataflow == "sequential" for t in groups]),
        pes=np.array([float(t.arch.num_pes) for t in groups]),
        macs=np.array([float(t.total_macs) for t in groups]),
        dmacs=np.array([float(t.total_delivery_macs) for t in groups]),
        cycles=np.array([t.total_compute_cycles for t in groups]),
        mul_frac=np.array([t.mul_frac for t in groups]),
        issue_ratio=np.array([t.issue_ratio for t in groups]),
        dlvw_frac=np.array([t.dlvw_frac for t in groups]),
        Lmax=Lmax)


def build_plan(groups: Sequence[TrafficTable], gidx: Sequence[int],
               points: Sequence[Any], nvms: Sequence[str]) -> PricingPlan:
    """Flatten mapped traffic groups + point coordinates into one plan.

    ``points`` need ``workload_name`` / ``node`` attributes plus a
    ``placement`` (or legacy ``variant``/``nvm`` pair — ``DesignPoint``
    satisfies both); ``nvms`` is the resolved NVM device per point, the
    default that deferred placement entries bind to. Each point's per-level
    technology VECTOR (``Placement.techs_for``) is what the pricing pass
    batches on — a hybrid hierarchy is just another row of ``tech_idx``.
    """
    groups = tuple(groups)
    gidx = np.asarray(gidx, int)
    P = len(points)
    g = group_geometry(groups)
    g_mask, g_names, g_cls = g["mask"], g["names"], g["cls"]
    g_macro, g_cap, g_bus = g["macro"], g["cap"], g["bus"]
    g_count, g_read, g_write = g["count"], g["read"], g["write"]
    g_tech, g_is_cpu, g_pes = g["tech"], g["is_cpu"], g["pes"]
    g_macs, g_dmacs, g_cycles = g["macs"], g["dmacs"], g["cycles"]
    g_mulf, g_issue, g_dlvw = g["mul_frac"], g["issue_ratio"], g["dlvw_frac"]

    nodes = tuple(p.node for p in points)
    node_list, node_idx = np.unique(np.array(nodes, int),
                                    return_inverse=True)
    clock_per_pt = [(p.node, groups[g].arch.clock_class)
                    for p, g in zip(points, gidx)]
    clock_keys = tuple(dict.fromkeys(clock_per_pt))
    ckey_pos = {k: i for i, k in enumerate(clock_keys)}
    clock_idx = np.array([ckey_pos[k] for k in clock_per_pt], int)

    weight_cls = (g_cls == "weight")[gidx]
    tech_names = g_tech[gidx].copy()
    for i, (p, g) in enumerate(zip(points, gidx)):
        pl = getattr(p, "placement", None)
        if pl is None:
            pl = Placement.variant(p.variant, getattr(p, "nvm", None))
        levels = groups[g].arch.levels
        tech_names[i, :len(levels)] = pl.techs_for(levels,
                                                   default_nvm=nvms[i])
    tech_list, tech_idx = np.unique(tech_names.astype(str),
                                    return_inverse=True)
    tech_idx = tech_idx.reshape(tech_names.shape)

    return PricingPlan(
        points=tuple(points), groups=groups, gidx=gidx,
        workloads=tuple(p.workload_name for p in points),
        arch_names=tuple(groups[g].arch.name for g in gidx),
        variants=tuple(p.variant for p in points),
        nvms=tuple(nvms), nodes=nodes,
        node_list=tuple(int(n) for n in node_list), node_idx=node_idx,
        clock_keys=clock_keys, clock_idx=clock_idx,
        is_cpu=g_is_cpu[gidx], num_pes=g_pes[gidx], macs=g_macs[gidx],
        delivery_macs=g_dmacs[gidx], compute_cycles=g_cycles[gidx],
        mul_frac=g_mulf[gidx], issue_ratio=g_issue[gidx],
        dlvw_frac=g_dlvw[gidx],
        mask=g_mask[gidx], level_names=g_names[gidx], level_cls=g_cls[gidx],
        weight_cls=weight_cls, macro_kb=g_macro[gidx],
        capacity_kb=g_cap[gidx], bus_bits=g_bus[gidx], count=g_count[gidx],
        read_bits=g_read[gidx], write_bits=g_write[gidx],
        tech_names=tech_names, tech_list=tuple(str(t) for t in tech_list),
        tech_idx=tech_idx)


def _device_col(plan: PricingPlan, attr: str) -> np.ndarray:
    """Gather one MemDevice attribute to (P, L) — re-read every call so
    device-table mutation (calibration, grid search) is always honored."""
    table = np.array([float(getattr(dev.DEVICES[t], attr))
                      for t in plan.tech_list])
    return table[plan.tech_idx]


def unit_energy_pj_per_bit(plan: PricingPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(point, level) access energies (read_pj_per_bit, write_pj_per_bit)
    under the plan's technology map — the exact formula ``price`` uses.
    Exposed so the system reload model (``core.schedule``) charges context-
    switch weight writes at the same unit cost as inference traffic; device
    constants are re-read on every call (mutation-safe)."""
    rm = _device_col(plan, "read_mult")
    wm = _device_col(plan, "write_mult")
    scale = _node_col(plan, dev.NODE_ENERGY_SCALE)
    e45 = dev.sram_e45_pj_per_bit(plan.macro_kb)
    cf = dev.cell_energy_fraction(plan.macro_kb)
    base_e = e45 * scale[:, None]
    return base_e * ((1.0 - cf) + cf * rm), base_e * ((1.0 - cf) + cf * wm)


def _node_col(plan: PricingPlan, table: Dict[int, float]) -> np.ndarray:
    return np.array([table[n] for n in plan.node_list])[plan.node_idx]


# ---------------------------------------------------------------------------
# EnergyTable: Accelergy-lite over the whole plan in one vectorized pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnergyTable:
    """All per-point energy/latency columns for a priced design space.

    Aggregate columns mirror the ``EnergyReport`` properties 1:1 (same
    names, vectorized over the point axis); ``row(i)`` materializes the
    scalar dataclass view.
    """
    plan: PricingPlan
    read_pj: np.ndarray          # (P, L)
    write_pj: np.ndarray         # (P, L)
    standby_w_pl: np.ndarray     # (P, L)
    read_power_w: np.ndarray     # (P, L)
    sram_leak_w: np.ndarray      # (P, L)
    nonvolatile: np.ndarray      # (P, L) bool
    compute_pj: np.ndarray       # (P,)
    delivery_pj: np.ndarray      # (P,)
    latency_s: np.ndarray        # (P,)
    compute_cycles: np.ndarray   # (P,)
    bottleneck: np.ndarray       # (P,) object

    def __post_init__(self) -> None:
        freeze_arrays(self)

    def __len__(self) -> int:
        return self.plan.n_points

    @property
    def points(self):
        return self.plan.points

    # --- aggregate columns (EnergyReport property parity) -------------------
    @property
    def macs(self) -> np.ndarray:
        return self.plan.macs

    @property
    def mem_read_pj(self) -> np.ndarray:
        return self.delivery_pj + self.read_pj.sum(axis=1)

    @property
    def mem_write_pj(self) -> np.ndarray:
        return self.write_pj.sum(axis=1)

    @property
    def mem_pj(self) -> np.ndarray:
        return self.mem_read_pj + self.mem_write_pj

    @property
    def buffer_pj(self) -> np.ndarray:
        return (self.read_pj + self.write_pj).sum(axis=1)

    @property
    def total_pj(self) -> np.ndarray:
        return self.compute_pj + self.mem_pj

    @property
    def edp(self) -> np.ndarray:
        return self.total_pj * 1e-12 * self.latency_s

    @property
    def standby_w(self) -> np.ndarray:
        return self.standby_w_pl.sum(axis=1)

    @property
    def weight_standby_w(self) -> np.ndarray:
        return (self.standby_w_pl * self.plan.weight_cls).sum(axis=1)

    @property
    def max_ips(self) -> np.ndarray:
        return 1.0 / self.latency_s

    @property
    def wake_energy_j(self) -> np.ndarray:
        return dev.WAKEUP_TIME_S * (self.sram_leak_w
                                    * self.nonvolatile).sum(axis=1)

    def mem_pj_by_cls(self, cls: str) -> np.ndarray:
        sel = self.plan.level_cls == cls
        return ((self.read_pj + self.write_pj) * sel).sum(axis=1)

    # --- NVM power model (vectorized core.nvm) ------------------------------
    def memory_power_at(self, ips) -> np.ndarray:
        """Average memory-subsystem power (W) per point; ``ips`` is a scalar
        or a per-point (P,) array."""
        return _pmem(self.mem_pj * 1e-12, self.latency_s, self.standby_w,
                     self.wake_energy_j, np.asarray(ips, float))

    def weight_memory_power_at(self, ips) -> np.ndarray:
        return _pweight(self.mem_pj_by_cls("weight") * 1e-12, self.latency_s,
                        self.weight_standby_w, np.asarray(ips, float))

    def memory_power_curves(self, ips_grid) -> "PowerTable":
        """Whole Fig-5 curves in one shot: (P, G) power surface over a
        shared IPS grid."""
        ips = np.asarray(ips_grid, float)
        g = ips[None, :]
        p_mem = _pmem(self.mem_pj[:, None] * 1e-12, self.latency_s[:, None],
                      self.standby_w[:, None], self.wake_energy_j[:, None], g)
        p_weight = _pweight(self.mem_pj_by_cls("weight")[:, None] * 1e-12,
                            self.latency_s[:, None],
                            self.weight_standby_w[:, None], g)
        return PowerTable(self, ips, p_mem, p_weight)

    def column(self, metric: str, ips: float = 10.0) -> np.ndarray:
        """Named metric column: any aggregate property, or ``pmem`` (uses
        ``ips``)."""
        if metric == "pmem":
            return self.memory_power_at(ips)
        return np.asarray(getattr(self, metric), float)

    # --- scalar view --------------------------------------------------------
    def row(self, i: int) -> EnergyReport:
        """Legacy ``EnergyReport`` dataclass as a row view."""
        p = self.plan
        levels: Dict[str, LevelEnergy] = {}
        for j in range(p.mask.shape[1]):
            if not p.mask[i, j]:
                continue
            levels[str(p.level_names[i, j])] = LevelEnergy(
                float(self.read_pj[i, j]), float(self.write_pj[i, j]),
                float(self.standby_w_pl[i, j]), str(p.tech_names[i, j]),
                str(p.level_cls[i, j]), float(self.read_power_w[i, j]),
                float(self.sram_leak_w[i, j]))
        return EnergyReport(
            p.arch_names[i], p.variants[i], p.nvms[i], p.nodes[i],
            p.workloads[i], int(p.macs[i]), float(self.compute_pj[i]),
            float(self.delivery_pj[i]), levels, float(self.latency_s[i]),
            float(self.compute_cycles[i]), str(self.bottleneck[i]))

    def rows(self) -> List[EnergyReport]:
        return [self.row(i) for i in range(len(self))]


def price(plan: PricingPlan) -> EnergyTable:
    """Vectorized ``energy.price`` over an entire plan in one numpy pass.

    Identical formulas to the scalar path; device/technology constants are
    re-read from ``core.devices`` on every call (mutation-safe)."""
    P = plan.n_points
    if P == 0:
        # keep the level axis: (0, 0) columns break every (P, L)-shaped
        # aggregate ((standby_w_pl * weight_cls).sum, mem_pj_by_cls, ...)
        # as soon as the plan's groups have real levels
        L = plan.mask.shape[1]
        z2, z1 = np.zeros((0, L)), np.zeros(0)
        return EnergyTable(plan, z2, z2, z2, z2, z2, z2.astype(bool),
                           z1, z1, z1, z1, np.empty(0, object))
    lm = _device_col(plan, "leak_mult")
    rc = _device_col(plan, "read_cycles")
    wc = _device_col(plan, "write_cycles")
    nv = _device_col(plan, "nonvolatile").astype(bool) & plan.mask

    scale = _node_col(plan, dev.NODE_ENERGY_SCALE)          # (P,)
    clock_tbl = np.array([dev.clock_ghz(n, c) * 1e9
                          for n, c in plan.clock_keys])
    clock = clock_tbl[plan.clock_idx]                       # (P,)

    er, ew = unit_energy_pj_per_bit(plan)
    read_pj = plan.read_bits * er
    write_pj = plan.write_bits * ew
    port = np.where(plan.weight_cls, 1.0, dev.ACT_PORT_LEAK_MULT)
    leak_base = (dev.SRAM_LEAK_UW_PER_KB_45 * plan.capacity_kb
                 * scale[:, None] * port * 1e-6)
    standby = leak_base * lm
    read_power = er * 1e-12 * plan.bus_bits * clock[:, None] * plan.mask
    cycles = (plan.read_bits / plan.bus_bits * rc
              + plan.write_bits / plan.bus_bits * wc)

    # Precision-aware compute plane (DESIGN.md §10): the plan carries the
    # dimensionless geometry (mul_frac/issue_ratio/dlvw_frac), constants are
    # read HERE so device-table mutation is honored. At the int8 anchor the
    # extra terms are exactly 0.0 * C and 1.0 * C — bit-identical pricing.
    mac_pj = (dev.MAC_INT8_PJ_45 + dev.MAC_MUL_PJ_45 * plan.mul_frac
              + np.where(plan.is_cpu, dev.CPU_OP_OVERHEAD_PJ_45, 0.0)
              * plan.issue_ratio) * scale
    compute_pj = plan.macs * mac_pj
    dpj45 = (np.where(plan.is_cpu, dfl.CPU_DELIVERY_PJ_PER_MAC_45,
                      dfl.DELIVERY_PJ_PER_MAC_45)
             * (1.0 + dfl.DELIVERY_WIDTH_FRAC * plan.dlvw_frac))
    delivery_pj = plan.delivery_macs * dpj45 * scale

    lvl_max = cycles.max(axis=1)
    jmax = cycles.argmax(axis=1)
    mem_bound = lvl_max > plan.compute_cycles
    cyc = np.where(mem_bound, lvl_max, plan.compute_cycles)
    names_at_max = plan.level_names[np.arange(P), jmax]
    bottleneck = np.where(mem_bound, names_at_max, "compute")
    latency = cyc / clock

    return EnergyTable(plan, read_pj, write_pj, standby, read_power,
                       leak_base, nv, compute_pj, delivery_pj, latency,
                       plan.compute_cycles, bottleneck)


# ---------------------------------------------------------------------------
# PowerTable + batched cross-over (vectorized core.nvm)
# ---------------------------------------------------------------------------


def _pmem(e_mem_j, latency_s, standby_w, wake_j, ips):
    """P(ips) = ips*E_mem + idle_frac*P_standby + ips*idle_frac*E_wake.

    The wake ramp is charged per GATING event, not per inference: at duty=1
    back-to-back inferences never power the gated levels off, so the rate of
    wake events falls with the idle fraction (``nvm.memory_power_w`` is the
    scalar oracle of this formula — keep the two in lockstep)."""
    duty = np.minimum(1.0, ips * latency_s)
    idle = np.maximum(0.0, 1.0 - duty)
    return ips * e_mem_j + idle * standby_w + ips * idle * wake_j


def _pweight(e_weight_j, latency_s, weight_standby_w, ips):
    """Weight-class-only power: no wake term (``nvm.weight_memory_power_w``)."""
    duty = np.minimum(1.0, ips * latency_s)
    return ips * e_weight_j + np.maximum(0.0, 1.0 - duty) * weight_standby_w


@dataclass(frozen=True)
class PowerTable:
    """Memory power of every point over a shared IPS grid (paper Fig 5)."""
    energy: EnergyTable
    ips: np.ndarray           # (Q,) shared IPS grid
    p_mem_w: np.ndarray       # (P, Q)
    p_weight_w: np.ndarray    # (P, Q)

    def __post_init__(self) -> None:
        freeze_arrays(self)

    def curve(self, i: int) -> np.ndarray:
        return self.p_mem_w[i]


def crossover_ips(table: EnergyTable, nvm_rows, sram_rows,
                  lo: float = 1e-4) -> np.ndarray:
    """Batched-bisection ``nvm.crossover_ips`` for row pairs of one table.

    Returns (K,) IPS values; NaN encodes the scalar path's ``None``
    (NVM never saves). Saves-everywhere pairs return the NVM variant's
    ``max_ips`` cap, exactly like the scalar oracle."""
    nvm_rows = np.asarray(nvm_rows, int)
    sram_rows = np.asarray(sram_rows, int)
    en = table.mem_pj[nvm_rows] * 1e-12
    ln = table.latency_s[nvm_rows]
    sn = table.standby_w[nvm_rows]
    wn = table.wake_energy_j[nvm_rows]
    es = table.mem_pj[sram_rows] * 1e-12
    ls = table.latency_s[sram_rows]
    ss = table.standby_w[sram_rows]
    ws = table.wake_energy_j[sram_rows]

    def f(x):
        return (_pmem(en, ln, sn, wn, x) - _pmem(es, ls, ss, ws, x))

    K = len(nvm_rows)
    hi0 = table.max_ips[nvm_rows]
    lo_a, hi = np.full(K, float(lo)), hi0.copy()
    never = f(lo_a) >= 0
    saves_everywhere = f(hi0) < 0
    out = np.where(saves_everywhere, hi0, np.nan)   # -> max_ips cap
    active = ~never & ~saves_everywhere
    for _ in range(80):                      # batched geometric bisection
        mid = (lo_a * hi) ** 0.5
        neg = f(mid) < 0
        lo_a = np.where(neg, mid, lo_a)
        hi = np.where(neg, hi, mid)
    out = np.where(active, (lo_a * hi) ** 0.5, out)
    out[never] = np.nan
    return out


# ---------------------------------------------------------------------------
# AreaTable (vectorized core.area)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AreaTable:
    """CACTI-lite area columns for a plan; ``row(i)`` -> ``AreaReport``."""
    plan: PricingPlan
    levels_mm2: np.ndarray    # (P, L)
    compute_mm2: np.ndarray   # (P,)

    def __post_init__(self) -> None:
        freeze_arrays(self)

    def __len__(self) -> int:
        return self.plan.n_points

    @property
    def memory_mm2(self) -> np.ndarray:
        return self.levels_mm2.sum(axis=1)

    @property
    def total_mm2(self) -> np.ndarray:
        return self.memory_mm2 + self.compute_mm2

    def row(self, i: int) -> area_mod.AreaReport:
        p = self.plan
        levels = {str(p.level_names[i, j]): float(self.levels_mm2[i, j])
                  for j in range(p.mask.shape[1]) if p.mask[i, j]}
        return area_mod.AreaReport(p.arch_names[i], p.variants[i],
                                   p.nodes[i], levels,
                                   float(self.compute_mm2[i]))

    def rows(self) -> List[area_mod.AreaReport]:
        return [self.row(i) for i in range(len(self))]


def area(plan: PricingPlan) -> AreaTable:
    """Vectorized ``area.area`` over the whole plan (one numpy pass)."""
    cell_mult = _device_col(plan, "cell_area_mult")
    sscale = _node_col(plan, dev.SRAM_AREA_SCALE)
    bits = plan.macro_kb * 1024 * 8
    sram_cell = bits * dev.SRAM_CELL_UM2_45 * sscale[:, None] / 1e6
    dual = np.where(plan.weight_cls, 1.0, dev.ACT_PORT_AREA_MULT)
    cell = sram_cell * cell_mult * dual
    periph = sram_cell * (dev.PERIPH_A + dev.PERIPH_B
                          / np.sqrt(np.maximum(plan.macro_kb, 1.0)))
    levels_mm2 = (cell + periph) * plan.count * plan.mask
    nascale = _node_col(plan, dev.NODE_AREA_SCALE)
    compute = (plan.num_pes * dev.MAC_AREA_UM2_45 * nascale / 1e6
               * (1 + area_mod.LOGIC_OVERHEAD))
    return AreaTable(plan, levels_mm2, compute)
