"""CACTI/FinCACTI-lite area model (paper Table 2).

Memory area = per-bank cell array (device-dependent: MRAM cells are 1.3-2.5x
smaller than high-density SRAM [18]) + periphery (device-INdependent: sense
amps / decoders / drivers do not shrink with the cell — the paper's stated
reason P0's small weight macros see only marginal area benefit).
Compute area scales with DeepScale-style logic factors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core import devices as dev
from repro_torch.core.archspec import ArchSpec

# Non-memory, non-MAC logic (NoC routers, sequencers, IO) as a fraction of
# compute area — systolic arrays are wiring-heavy.
LOGIC_OVERHEAD = 2.0


@dataclass
class AreaReport:
    arch: str
    variant: str
    node: int
    levels: Dict[str, float]          # mm^2 per level
    compute_mm2: float

    @property
    def memory_mm2(self) -> float:
        return sum(self.levels.values())

    @property
    def total_mm2(self) -> float:
        return self.memory_mm2 + self.compute_mm2


def area(arch: ArchSpec, node: int, variant: str = "sram") -> AreaReport:
    levels = {}
    for lvl in arch.levels:
        dual = lvl.cls != "weight"
        bank = dev.macro_area_mm2(lvl.tech, lvl.macro_kb, node, dual_port=dual)
        levels[lvl.name] = bank * lvl.count
    compute = dev.compute_area_mm2(arch.num_pes, node) * (1 + LOGIC_OVERHEAD)
    return AreaReport(arch.name, variant, node, levels, compute)


def savings(nvm: AreaReport, sram: AreaReport) -> float:
    return 1.0 - nvm.total_mm2 / sram.total_mm2


def area_space(traffic_groups, gidx, points, nvms):
    """Vectorized ``area`` over a whole design space in one numpy pass.

    Same inputs as ``energy.price_space`` (per-level technologies resolved
    from each point's ``placement``); returns a ``columns.AreaTable``
    whose ``row(i)`` is the ``AreaReport`` view. The scalar ``area`` above
    stays the single-point reference implementation."""
    from repro_torch.core import columns
    return columns.area(columns.build_plan(traffic_groups, gidx, points,
                                           nvms))
