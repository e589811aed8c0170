"""Accelergy-lite: price dataflow access counts under a technology variant.

Produces per-inference energy (compute / per-level read / write), latency
(max of compute and per-level memory cycles, with multi-cycle NVM accesses),
retention/standby powers for the IPS analysis, and EDP.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from repro_torch.core import dataflow as dfl
from repro_torch.core import devices as dev
from repro_torch.core.archspec import ArchSpec, MemLevel
from repro_torch.core.dataflow import LayerAccess, total_traffic


@dataclass
class LevelEnergy:
    read_pj: float
    write_pj: float
    standby_w: float       # retention power if idled in SRAM-standby mode
    tech: str
    cls: str
    read_power_w: float = 0.0   # peak streaming read power
    sram_leak_w: float = 0.0    # SRAM-equivalent retention power (wake model)


@dataclass
class EnergyReport:
    arch: str
    variant: str
    nvm: str
    node: int
    workload: str
    macs: int
    compute_pj: float                  # MAC datapath
    delivery_pj: float                 # operand NoC / collectors (read-class)
    levels: Dict[str, LevelEnergy]
    latency_s: float
    compute_cycles: float
    bottleneck: str                    # level name or "compute"

    # --- aggregates --------------------------------------------------------
    @property
    def mem_read_pj(self) -> float:
        return self.delivery_pj + sum(l.read_pj for l in self.levels.values())

    @property
    def mem_write_pj(self) -> float:
        return sum(l.write_pj for l in self.levels.values())

    @property
    def mem_pj(self) -> float:
        return self.mem_read_pj + self.mem_write_pj

    @property
    def buffer_pj(self) -> float:
        """Buffer-level memory energy only (no operand-delivery fabric) —
        the quantity the paper's Fig 5 / Table 3 memory-power analysis uses
        ("memory power (total, weight, I/O buffer)")."""
        return sum(l.read_pj + l.write_pj for l in self.levels.values())

    @property
    def total_pj(self) -> float:
        return self.compute_pj + self.mem_pj

    @property
    def edp(self) -> float:
        """Energy-delay product (J*s)."""
        return self.total_pj * 1e-12 * self.latency_s

    @property
    def standby_w(self) -> float:
        """Idle retention power: volatile levels must hold state in drowsy
        standby (current 100x below read [11]); NVM levels power OFF."""
        return sum(l.standby_w for l in self.levels.values())

    @property
    def weight_standby_w(self) -> float:
        return sum(l.standby_w for l in self.levels.values()
                   if l.cls == "weight")

    @property
    def max_ips(self) -> float:
        return 1.0 / self.latency_s

    def mem_pj_by_cls(self, cls: str) -> float:
        return sum(l.read_pj + l.write_pj for l in self.levels.values()
                   if l.cls == cls)


def _read_power_w(level: MemLevel, node: int, clock_hz: float) -> float:
    """Peak continuous read power of the level (all banks streaming)."""
    e_pj_per_bit = dev.mem_energy_pj_per_bit(level.tech, level.macro_kb,
                                             node, "read")
    return e_pj_per_bit * 1e-12 * level.bus_bits * clock_hz


def price(accesses: Sequence[LayerAccess], arch: ArchSpec, node: int,
          workload: str, variant: str = "sram", nvm: str = "sram"
          ) -> EnergyReport:
    """Price one workload's access counts on one (already tech-mapped) arch."""
    traffic = total_traffic(accesses)
    macs = sum(a.macs for a in accesses)
    dmacs = sum(a.delivery_macs for a in accesses)
    is_cpu = arch.dataflow == "sequential"
    scale = dev.NODE_ENERGY_SCALE[node]
    clock_hz = dev.clock_ghz(node, arch.clock_class) * 1e9

    # Precision-aware compute plane (DESIGN.md §10), as MACs-weighted means
    # over the layers — the same aggregated form (and operation order) the
    # columnar pass uses, so the two paths stay in bitwise lockstep at the
    # INT8 anchor (mul/dlvw terms exactly 0.0, issue ratio exactly 1.0).
    mul_frac = float(sum(a.macs * dev.mac_mul_units(a.weight_bits, a.act_bits)
                         for a in accesses) / macs)
    issue_ratio = float(sum(
        a.macs / float(arch.compute.macs_per_pe_per_cycle(a.weight_bits,
                                                          a.act_bits))
        for a in accesses) / macs)
    dlvw_frac = (float(sum(
        a.delivery_macs * dev.delivery_width_units(a.weight_bits, a.act_bits)
        for a in accesses) / dmacs) if dmacs else 0.0)
    mac_pj = (dev.MAC_INT8_PJ_45 + dev.MAC_MUL_PJ_45 * mul_frac
              + (dev.CPU_OP_OVERHEAD_PJ_45 if is_cpu else 0.0) * issue_ratio
              ) * scale
    compute_pj = macs * mac_pj
    dpj = ((dfl.CPU_DELIVERY_PJ_PER_MAC_45 if is_cpu
            else dfl.DELIVERY_PJ_PER_MAC_45)
           * (1.0 + dfl.DELIVERY_WIDTH_FRAC * dlvw_frac))
    delivery_pj = dmacs * dpj * scale

    levels: Dict[str, LevelEnergy] = {}
    level_cycles: Dict[str, float] = {}
    for lvl in arch.levels:
        tr = traffic.get(lvl.name)
        if tr is None:
            continue
        er = dev.mem_energy_pj_per_bit(lvl.tech, lvl.macro_kb, node, "read")
        ew = dev.mem_energy_pj_per_bit(lvl.tech, lvl.macro_kb, node, "write")
        d = dev.DEVICES[lvl.tech]
        rp = _read_power_w(lvl, node, clock_hz)
        port_mult = 1.0 if lvl.cls == "weight" else dev.ACT_PORT_LEAK_MULT
        standby = (dev.mem_leakage_uw(lvl.tech, lvl.capacity_kb, node)
                   * port_mult * 1e-6)
        sleak = (dev.mem_leakage_uw("sram", lvl.capacity_kb, node)
                 * port_mult * 1e-6)
        levels[lvl.name] = LevelEnergy(tr.read_bits * er, tr.write_bits * ew,
                                       standby, lvl.tech, lvl.cls, rp, sleak)
        level_cycles[lvl.name] = (tr.read_bits / lvl.bus_bits * d.read_cycles
                                  + tr.write_bits / lvl.bus_bits * d.write_cycles)

    compute_cycles = sum(a.compute_cycles for a in accesses)
    if level_cycles and max(level_cycles.values()) > compute_cycles:
        bottleneck = max(level_cycles, key=level_cycles.get)
        cycles = level_cycles[bottleneck]
    else:
        bottleneck, cycles = "compute", compute_cycles
    latency_s = cycles / clock_hz

    return EnergyReport(arch.name, variant, nvm, node, workload, macs,
                        compute_pj, delivery_pj, levels, latency_s,
                        compute_cycles, bottleneck)


def price_space(traffic_groups, gidx, points, nvms):
    """Vectorized ``price`` over a whole design space in one numpy pass.

    ``traffic_groups`` are ``columns.TrafficTable``s (one per mapped
    (workload, sized-arch) pair), ``gidx`` maps each point to its group,
    ``nvms`` is the resolved default device per point (what each point's
    ``placement`` binds deferred entries to — see ``core.placement``; the
    per-level technology vectors the pass batches on come from
    ``Placement.techs_for``). Returns a ``columns.EnergyTable`` whose
    ``row(i)`` is the ``EnergyReport`` view. The scalar ``price`` above
    stays the single-point reference the parity suite checks the columnar
    path against."""
    from repro_torch.core import columns
    return columns.price(columns.build_plan(traffic_groups, gidx, points,
                                            nvms))
