"""NVM-oriented memory-power-vs-IPS analysis (paper §4-§5, Fig 5, Table 3).

Temporal model (paper Fig 3a/b): WU -> FA -> inference -> power-gate. Between
inferences:
  * volatile (SRAM) levels hold state in data-retentive standby, drawing
    current 100x below read current [11] — weights would otherwise need an
    energy-hungry reload;
  * non-volatile (MRAM) levels power OFF completely and pay a 100us wake-up
    ramp per inference event.

Average memory power at inference rate ``ips``:
    P(ips) = ips * E_mem_inference + idle_frac * P_standby
             + ips * idle_frac * E_wake

The wake ramp is charged per power-GATING event, not per inference: gated
levels only pay the 100us ramp when they actually powered off since the
previous inference, and the rate of gating events shrinks with the idle
fraction (at duty = 1 back-to-back inferences never power down, so the
wake term vanishes instead of being charged ``ips`` times).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core import devices as dev
from repro_torch.core.energy import EnergyReport


def wake_energy_j(report: EnergyReport) -> float:
    """Power-up ramp for gated (non-volatile) levels over the 100us wake
    window — rail-charge inrush at SRAM-retention-leakage scale. Volatile
    levels never power off (drowsy standby instead): no wake ramp."""
    ramp_w = sum(l.sram_leak_w for l in report.levels.values()
                 if dev.DEVICES[l.tech].nonvolatile)
    return dev.WAKEUP_TIME_S * ramp_w


def memory_power_w(report: EnergyReport, ips: float) -> float:
    """Average memory-subsystem power (W) at ``ips`` inferences/second.

    Includes the operand-delivery fabric (NoC + collectors): it is part of
    the memory subsystem's dynamic power (and why the paper's savings bands
    are nearly workload-independent — delivery scales with MACs), but it is
    register-class hardware: no variant converts it, and it is power-gated
    with the accelerator so it contributes no standby."""
    e_mem_j = report.mem_pj * 1e-12
    duty = min(1.0, ips * report.latency_s)
    idle_frac = max(0.0, 1.0 - duty)
    # wake is charged per gating EVENT (ips * idle_frac of them per second),
    # not per inference: at duty=1 gated levels never power off between
    # back-to-back inferences. Columnar twin: columns._pmem.
    return (ips * e_mem_j + idle_frac * report.standby_w
            + ips * idle_frac * wake_energy_j(report))


def weight_memory_power_w(report: EnergyReport, ips: float) -> float:
    """Weight-class-only memory power (Fig 5 'weight' curves)."""
    e_j = report.mem_pj_by_cls("weight") * 1e-12
    duty = min(1.0, ips * report.latency_s)
    return ips * e_j + max(0.0, 1.0 - duty) * report.weight_standby_w


def savings_at_ips(nvm_report: EnergyReport, sram_report: EnergyReport,
                   ips: float) -> float:
    """Fractional memory-power savings of an NVM variant vs SRAM-only."""
    p_sram = memory_power_w(sram_report, ips)
    p_nvm = memory_power_w(nvm_report, ips)
    return 1.0 - p_nvm / p_sram


def crossover_ips(nvm_report: EnergyReport, sram_report: EnergyReport,
                  lo: float = 1e-4) -> Optional[float]:
    """IPS at which the NVM variant stops saving memory power vs SRAM-only.

    Below the cross-over the NVM variant wins (standby elimination dominates);
    above it the higher per-inference MRAM energy wins. Capped at the maximum
    rate the (memory-limited) pipeline supports — the paper's "limited based
    on maximum frequency supported by the memory architecture".
    """
    hi = nvm_report.max_ips
    f = lambda ips: memory_power_w(nvm_report, ips) - memory_power_w(
        sram_report, ips)
    if f(lo) >= 0:
        return None                     # never saves
    if f(hi) < 0:
        return hi                       # saves everywhere it can run -> cap
    for _ in range(80):                 # bisection
        mid = (lo * hi) ** 0.5
        if f(mid) < 0:
            lo = mid
        else:
            hi = mid
    return (lo * hi) ** 0.5


# ---------------------------------------------------------------------------
# columnar entry points (whole-space / whole-curve, see core.columns)
# ---------------------------------------------------------------------------


def sram_pairs(points):
    """Pair every NVM-converting point with its SRAM baseline at the same
    (workload, arch, node, operand widths).

    Returns ``(mram_rows, sram_rows)`` index lists into ``points`` — the
    row pairing every batched savings/cross-over call needs (Fig 5,
    Table 3, the quant sweep); keeping it here stops callers hand-rolling
    the key. A point is a baseline iff its PLACEMENT converts no level
    (``Placement.converts_nothing``) — the legacy ``variant == "sram"``
    test generalized so an explicit all-``sram`` lattice point counts too.
    Precision is part of the key so mixed-precision spaces pair
    each corner against its own baseline; widths are NORMALIZED first
    (None -> the INT8 spec default, psum None -> derived) so a
    default-precision point and an explicit ``Bind(weight_bits=8,
    act_bits=8)`` corner — the same hardware — pair with each other."""
    pts = list(points)

    def key(p):
        return (p.workload_name, p.arch, p.node) + p.normalized_precision()

    sram = {key(p): i for i, p in enumerate(pts)
            if p.placement.converts_nothing}
    mram = [i for i, p in enumerate(pts)
            if not p.placement.converts_nothing]
    pairs = []
    for i in mram:
        j = sram.get(key(pts[i]))
        if j is None:
            p = pts[i]
            raise ValueError(
                f"sram_pairs: no all-SRAM baseline for converting point "
                f"(workload={p.workload_name!r}, arch={p.arch!r}, "
                f"node={p.node}, precision={p.precision_label!r}) — include "
                f"a converts-nothing point with the same key in the space "
                f"(e.g. variant='sram' or an all-'sram' lattice point)")
        pairs.append(j)
    return mram, pairs


def memory_power_curve(report: EnergyReport, ips_grid) -> np.ndarray:
    """Whole Fig-5 curve for ONE report: ``memory_power_w`` over an IPS grid
    in one vectorized shot (delegates to the columnar formula)."""
    from repro_torch.core.columns import _pmem
    return _pmem(report.mem_pj * 1e-12, report.latency_s, report.standby_w,
                 wake_energy_j(report), np.asarray(ips_grid, float))


def memory_power_curves(table, ips_grid):
    """Whole-space Fig-5 surface: (points x IPS-grid) ``PowerTable`` from a
    ``columns.EnergyTable`` in one vectorized pass."""
    return table.memory_power_curves(ips_grid)


def savings_at_ips_batch(table, nvm_rows, sram_rows, ips) -> np.ndarray:
    """Vectorized ``savings_at_ips`` for row pairs of an ``EnergyTable``;
    ``ips`` is a scalar or per-pair array."""
    from repro_torch.core.columns import _pmem
    nvm_rows = np.asarray(nvm_rows, int)
    sram_rows = np.asarray(sram_rows, int)
    ips = np.asarray(ips, float)
    e, lat = table.mem_pj * 1e-12, table.latency_s
    sb, wk = table.standby_w, table.wake_energy_j
    p_n = _pmem(e[nvm_rows], lat[nvm_rows], sb[nvm_rows], wk[nvm_rows], ips)
    p_s = _pmem(e[sram_rows], lat[sram_rows], sb[sram_rows], wk[sram_rows],
                ips)
    return 1.0 - p_n / p_s


def crossover_ips_batch(table, nvm_rows, sram_rows,
                        lo: float = 1e-4) -> np.ndarray:
    """Batched-bisection ``crossover_ips`` over row pairs of an
    ``EnergyTable``; NaN encodes the scalar path's ``None``."""
    from repro_torch.core import columns
    return columns.crossover_ips(table, nvm_rows, sram_rows, lo=lo)
