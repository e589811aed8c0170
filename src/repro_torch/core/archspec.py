"""Architecture specifications (paper Fig 2(d)).

Three simulated platforms:
  * ``cpu``     — generic in-order CPU, 64-bit memory bus, unified SRAM
                  (QKeras-style model [2]); baseline node 45nm.
  * ``eyeriss`` — row-stationary systolic array [1]: large shared global
                  buffer for activations, small per-PE weight scratchpads
                  backed by a global weight buffer; baseline node 40nm.
  * ``simba``   — weight-stationary chiplet [16]: per-PE weight buffers large
                  enough to pin weight tiles, shared input / accumulation
                  buffers; baseline node 40nm.

Buffer sizes follow the paper's method ("SRAM global buffer size was chosen
as per workload requirement"): the global weight buffer holds the full INT8
model (DRAM was removed), activation buffers hold the largest layer working
set; both are built from banked macros. ``pe_config`` "v1" is the published
array size; "v2" is the paper's scaled 64x64 array used for Table 3.

Energy-per-bit is a function of the MACRO size (a 224B spad is cheap per
access, a 256kB bank is not); capacity/area/leakage use macro x count.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import warnings
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.core.devices import COMPUTE_ARCHETYPES, ComputeSpec


@dataclass(frozen=True)
class MemLevel:
    """One level of the on-chip memory hierarchy (count x macro banks)."""
    name: str
    cls: str           # "weight" | "input" | "output" | "unified"
    macro_kb: float    # single-bank capacity (sets energy/bit)
    count: int         # number of banks / per-PE instances
    bus_bits: int      # total access width at this level
    tech: str = "sram"

    def __post_init__(self):
        # Validate at construction so a typo'd device name fails HERE with
        # the level named, not as a bare KeyError deep inside pricing.
        from repro_torch.core import devices as dev
        if self.tech not in dev.DEVICES:
            raise ValueError(
                f"memory level {self.name!r}: unknown technology "
                f"{self.tech!r} (known devices: {sorted(dev.DEVICES)})")

    @property
    def capacity_kb(self) -> float:
        return self.macro_kb * self.count

    @property
    def capacity_bits(self) -> float:
        return self.capacity_kb * 1024 * 8


@dataclass(frozen=True)
class ArchSpec:
    name: str
    dataflow: str                  # "sequential" | "row" | "weight"
    baseline_node: int
    pe_x: int                      # MAC lane grid
    pe_y: int
    levels: Tuple[MemLevel, ...]
    clock_class: str = "systolic"  # -> devices.BASE_CLOCK_GHZ_45
    # Precision-aware datapath archetype (devices.ComputeSpec): sets the
    # per-precision lane split the mappers bake into compute_cycles and the
    # issue-overhead amortization the pricers charge. Exactly neutral at the
    # INT8 anchor for every archetype.
    compute: ComputeSpec = COMPUTE_ARCHETYPES["systolic"]

    @property
    def num_pes(self) -> int:
        return self.pe_x * self.pe_y

    def with_tech(self, mapping: Dict[str, str]) -> "ArchSpec":
        unknown = set(mapping) - {l.name for l in self.levels}
        if unknown:
            raise KeyError(
                f"with_tech: {sorted(unknown)} are not levels of "
                f"{self.name!r} (levels: {[l.name for l in self.levels]})")
        # per-level tech validation happens in MemLevel.__post_init__
        new = tuple(dataclasses.replace(l, tech=mapping.get(l.name, l.tech))
                    for l in self.levels)
        return dataclasses.replace(self, levels=new)

    def level(self, name: str) -> MemLevel:
        for l in self.levels:
            if l.name == name:
                return l
        raise KeyError(name)


def _banks(total_kb: float, bank_kb: float) -> int:
    return max(1, int(math.ceil(total_kb / bank_kb)))


def cpu_spec(weight_kb: float = 4096, act_kb: float = 2048) -> ArchSpec:
    """QKeras CPU model: unified SRAM, 64-bit bus, sequential 8-wide MACs."""
    return ArchSpec(
        name="cpu", dataflow="sequential", baseline_node=45,
        pe_x=1, pe_y=8, clock_class="cpu",
        compute=COMPUTE_ARCHETYPES["cpu-simd"],
        levels=(
            MemLevel("weight_mem", "weight", 256, _banks(weight_kb, 256), 64),
            MemLevel("act_mem", "unified", 256, _banks(act_kb, 256), 64),
        ))


def xr_npe_spec(weight_kb: float = 4096, act_kb: float = 2048) -> ArchSpec:
    """XR-NPE-style mixed-precision SIMD coprocessor (PAPERS.md): CPU-class
    memory geometry (unified SRAM, 64-bit bus, sequential mapping, CPU
    clock) around a 2D lane-splitting vector datapath — w4a8 doubles and
    int4 quadruples MACs/cycle, and the per-issue overhead amortizes over
    the packed sub-ops (superlinear low-precision energy wins)."""
    base = cpu_spec(weight_kb, act_kb)
    return dataclasses.replace(base, name="xr-npe",
                               compute=COMPUTE_ARCHETYPES["xr-npe"])


def eyeriss_spec(pe_config: str = "v2", weight_kb: float = 4096,
                 act_kb: float = 2048) -> ArchSpec:
    """Row-stationary: acts resident in a large banked global buffer; weights
    stream from the global weight buffer into SMALL per-PE spads (224B, read
    every MAC), re-fetched per output row-strip."""
    pe = (12, 14) if pe_config == "v1" else (64, 64)
    return ArchSpec(
        name="eyeriss", dataflow="row", baseline_node=40,
        pe_x=pe[0], pe_y=pe[1],
        levels=(
            MemLevel("gwb", "weight", 256, _banks(weight_kb, 256), 64),
            # per-PE spads are accessed in parallel: aggregate bandwidth
            MemLevel("pe_spad", "weight", 0.224, pe[0] * pe[1],
                     16 * pe[0] * pe[1]),
            MemLevel("glb", "unified", 128, _banks(act_kb, 128), 64),
        ))


def simba_spec(pe_config: str = "v2", weight_kb: float = 4096,
               act_kb: float = 1024) -> ArchSpec:
    """Weight-stationary: per-PE 32kB weight buffers pin weight tiles (held
    in MAC operand registers across spatial reuse); shared banked input and
    accumulation buffers."""
    pe = (16, 16) if pe_config == "v1" else (64, 64)
    n_pe = 16 if pe_config == "v1" else 64          # buffer-owning PEs
    wb_macro = 32 if pe_config == "v1" else 64      # v2: weights resident
    return ArchSpec(
        name="simba", dataflow="weight", baseline_node=40,
        pe_x=pe[0], pe_y=pe[1],
        levels=(
            MemLevel("gwb", "weight", 256, _banks(weight_kb, 256), 64),
            MemLevel("pe_wb", "weight", wb_macro, n_pe, 64 * n_pe),
            MemLevel("input_buf", "input", 64, _banks(act_kb, 64), 64),
            MemLevel("accum_buf", "output", 24, n_pe, 24 * n_pe),
        ))


ARCHS = {"cpu": cpu_spec, "eyeriss": eyeriss_spec, "simba": simba_spec,
         "xr-npe": xr_npe_spec}

_ARCH_PARAMS = {n: frozenset(inspect.signature(fn).parameters)
                for n, fn in ARCHS.items()}


def get_arch(name: str, **kw) -> ArchSpec:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r} (one of {sorted(ARCHS)})")
    unknown = set(kw) - _ARCH_PARAMS[name]
    if unknown == {"pe_config"} and "pe_config" not in _ARCH_PARAMS[name]:
        # Historic asymmetry: sweeps carry pe_config for every point, but the
        # sequential models (cpu, xr-npe) have no PE array config. Warn-and-
        # ignore keeps those sweeps working; anything else unknown is a hard
        # error so a sweep definition can't silently diverge from intent.
        warnings.warn(
            f"get_arch({name!r}): ignoring pe_config (the {name} model has "
            "no PE array configuration)", stacklevel=2)
        kw.pop("pe_config")
    elif unknown:
        raise TypeError(
            f"get_arch({name!r}): unknown kwargs {sorted(unknown)} "
            f"(accepted: {sorted(_ARCH_PARAMS[name])})")
    return ARCHS[name](**kw)


# --- NVM variants (paper §4) -------------------------------------------------

VARIANTS = ("sram", "p0", "p1")


def apply_variant(spec: ArchSpec, variant: str, nvm: str) -> ArchSpec:
    """variant: 'sram' | 'p0' (weight levels -> NVM) | 'p1' (all -> NVM).

    Thin legacy wrapper over the first-class technology axis: the same
    mapping now comes from ``placement.Placement.variant`` (byte-parity
    asserted by ``tests/test_placement.py`` against the frozen seed rows).
    """
    from repro_torch.core.placement import Placement
    return Placement.variant(variant, nvm).apply(spec)
