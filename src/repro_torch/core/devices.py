"""Device & technology tables for the DSE plane (Accelergy/CACTI-lite).

All constants live HERE and nowhere else. Sources and calibration:

  * Node scaling factors follow DeepScaleTool [14] (energy) and the paper's
    own statement that 45/40nm -> 7nm yields "up to 4.5x" energy reduction.
  * SRAM access energies are a CACTI-style size-dependent model
    (wordline/bitline term ~ sqrt(capacity) + fixed periphery term).
  * MRAM device asymmetries follow [17] (STT, 28nm: read-optimized) and [18]
    (VGSOT, 7nm: write-optimized), with cell-area factors 1.3x / 2.3x / 2.5x
    (SOT / VGSOT / STT) from [18].
  * Exact macro tables of [17][18] are not available offline; the remaining
    free constants were calibrated so the full pipeline reproduces the
    paper's Tables 2-3 / Figs 2f,3d,4,5 bands (residuals recorded in
    EXPERIMENTS.md §Paper-validation). The *mechanics* (access counts,
    dataflow asymmetries) are never calibrated — only device constants.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Dict

import numpy as np

# ---------------------------------------------------------------------------
# technology nodes
# ---------------------------------------------------------------------------

# Energy scale relative to 45nm (DeepScale-style; 45->7nm ~= 4.5x reduction).
NODE_ENERGY_SCALE: Dict[int, float] = {
    45: 1.00, 40: 0.89, 28: 0.52, 22: 0.40, 7: 0.22,
}
# Logic-area scale relative to 45nm (~S^2-ish with FinFET flattening).
NODE_AREA_SCALE: Dict[int, float] = {
    45: 1.00, 40: 0.79, 28: 0.39, 22: 0.24, 7: 0.036,
}
# SRAM scales WORSE than logic in the FinFET era (bitcell scaling stalled).
SRAM_AREA_SCALE: Dict[int, float] = {
    45: 1.00, 40: 0.82, 28: 0.46, 22: 0.33, 7: 0.068,
}
# Delay scale (relative): sets achievable clock per node.
NODE_DELAY_SCALE: Dict[int, float] = {
    45: 1.00, 40: 0.93, 28: 0.70, 22: 0.60, 7: 0.40,
}

# ---------------------------------------------------------------------------
# memory devices
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemDevice:
    """Per-bit access/retention characteristics at the REFERENCE node (45nm
    for SRAM; MRAM entries are defined as multipliers over same-node SRAM)."""
    name: str
    read_mult: float      # read energy multiplier vs same-size SRAM macro
    write_mult: float     # write energy multiplier
    leak_mult: float      # standby leakage multiplier (retention mode)
    cell_area_mult: float # bit-cell area vs high-density SRAM cell
    read_cycles: int      # multi-cycle access (latency model)
    write_cycles: int
    nonvolatile: bool


# STT [17]: read-optimized (28nm-era commodity MRAM; the IoT case study's
# energy wins at the edge hinge on cheap reads), costly writes.
# SOT [18]: balanced; fast writes, moderate reads.
# VGSOT [18]: write-optimized scaled device; reads cost more than SRAM.
DEVICES: Dict[str, MemDevice] = {
    "sram": MemDevice("sram", 1.00, 1.05, 1.00, 1.000, 1, 1, False),
    "stt": MemDevice("stt", 0.75, 3.50, 0.00, 1 / 2.5, 1, 4, True),
    "sot": MemDevice("sot", 1.05, 1.40, 0.00, 1 / 1.3, 1, 2, True),
    # 7nm VGSOT [18]: reads <=5ns i.e. SRAM-equivalent single-cycle (paper §5),
    # writes assumed multi-cycle ("support for multi-cycle read and write").
    "vgsot": MemDevice("vgsot", 2.00, 0.55, 0.00, 1 / 2.3, 1, 2, True),
}

# Node -> which MRAM device the paper uses for its P0/P1 estimates.
PAPER_NVM_AT_NODE = {28: "stt", 7: "vgsot"}

# ---------------------------------------------------------------------------
# SRAM macro model (CACTI-lite) at the 45nm reference node
# ---------------------------------------------------------------------------

# E_access(bits_per_access, capacity) = per-bit energy with a sqrt(capacity)
# bitline term plus a fixed sense/decode term. Values in pJ/bit @ 45nm.
SRAM_E_BASE_PJ_BIT = 0.045          # sense-amp / decoder floor
SRAM_E_SQRT_PJ_BIT = 0.0085         # per sqrt(kB) wordline/bitline growth
SRAM_LEAK_UW_PER_KB_45 = 0.035      # drowsy-retention leakage @45nm, uW/kB
# Activation buffers are dual-ported (simultaneous producer/consumer) —
# larger cells, ~2x retention leakage vs single-port weight macros.
ACT_PORT_LEAK_MULT = 2.0

# SRAM bit-cell area @ 45nm (um^2/bit), high-density 6T.
SRAM_CELL_UM2_45 = 0.38
# Periphery area overhead: fraction ~ a + b / sqrt(kB)  (small macros pay
# proportionally more periphery -- the paper's stated reason P0 area savings
# are small for small weight buffers).
PERIPH_A = 0.18
PERIPH_B = 0.95

# MRAM periphery does NOT shrink with the cell (same sense/drive circuits):
# only the cell array scales by cell_area_mult.


# Fraction of a macro's access energy spent in the CELL ARRAY (vs periphery:
# sense amps / decoders / drivers, which are device-INdependent). Grows with
# macro size; interpolated in log-capacity. A 224B spad is periphery-dominated
# so an MRAM swap barely moves its access energy; a 256kB bank is array-
# dominated and sees most of the device multiplier.
CELL_FRAC_MIN, CELL_FRAC_MAX = 0.60, 0.95
CELL_FRAC_SLOPE = 0.20          # per decade of kB above 0.25kB


def cell_energy_fraction(capacity_kb):
    """Elementwise (scalar or ndarray) — the columnar core calls this on
    whole (point x level) macro-size arrays; one source of truth."""
    decades = np.log10(np.maximum(capacity_kb, 0.25) / 0.25)
    return np.minimum(CELL_FRAC_MAX, CELL_FRAC_MIN + CELL_FRAC_SLOPE * decades)


def sram_e45_pj_per_bit(capacity_kb):
    """SRAM access energy at the 45nm reference, elementwise."""
    return (SRAM_E_BASE_PJ_BIT
            + SRAM_E_SQRT_PJ_BIT * np.sqrt(np.maximum(capacity_kb, 1.0)))


def sram_read_pj_per_bit(capacity_kb: float, node: int) -> float:
    return sram_e45_pj_per_bit(capacity_kb) * NODE_ENERGY_SCALE[node]


def mem_energy_pj_per_bit(dev: str, capacity_kb: float, node: int,
                          op: str) -> float:
    d = DEVICES[dev]
    base = sram_read_pj_per_bit(capacity_kb, node)
    mult = d.read_mult if op == "read" else d.write_mult
    cf = cell_energy_fraction(capacity_kb)
    return base * ((1.0 - cf) + cf * mult)


def mem_leakage_uw(dev: str, capacity_kb: float, node: int) -> float:
    """Retention (drowsy-standby) power; ~read-current/100-class [11]."""
    d = DEVICES[dev]
    return (SRAM_LEAK_UW_PER_KB_45 * capacity_kb * NODE_ENERGY_SCALE[node]
            * d.leak_mult)


# Dual-ported activation buffers use ~2x larger cells than single-port
# weight macros (matches the retention-leakage factor above).
ACT_PORT_AREA_MULT = 2.0


def cell_area_mm2(dev: str, capacity_kb: float, node: int,
                  dual_port: bool = False) -> float:
    """Bit-cell array area (no periphery)."""
    d = DEVICES[dev]
    bits = capacity_kb * 1024 * 8
    um2 = bits * SRAM_CELL_UM2_45 * SRAM_AREA_SCALE[node] * d.cell_area_mult
    if dual_port:
        um2 *= ACT_PORT_AREA_MULT
    return um2 / 1e6


def periphery_area_mm2(capacity_kb: float, node: int) -> float:
    """Periphery scales with the SRAM-equivalent array (device-independent)."""
    sram_array = cell_area_mm2("sram", capacity_kb, node)
    frac = PERIPH_A + PERIPH_B / math.sqrt(max(capacity_kb, 1.0))
    return sram_array * frac


def macro_area_mm2(dev: str, capacity_kb: float, node: int,
                   dual_port: bool = False) -> float:
    return (cell_area_mm2(dev, capacity_kb, node, dual_port)
            + periphery_area_mm2(capacity_kb, node))


# ---------------------------------------------------------------------------
# compute (MAC) model — precision-aware (DESIGN.md §10)
# ---------------------------------------------------------------------------

# INT8 MAC energy @ 45nm reference (pJ/op). The CPU pays instruction-stream
# overhead per op (fetch/decode/regfile) on top of the raw datapath — this is
# what makes CPU *compute*-dominated (paper Fig 2e).
MAC_INT8_PJ_45 = 0.40
CPU_OP_OVERHEAD_PJ_45 = 0.20        # QKeras prices near-datapath CPU ops [2]
MAC_AREA_UM2_45 = 410.0             # INT8 MAC + pipeline registers

# Peak clock at 45nm reference (logic-limited), per architecture class.
BASE_CLOCK_GHZ_45 = {"cpu": 2.0, "systolic": 0.45}

# Calibrated compute-plane constants: ``calibrate/calibrated.json`` of this
# package, a byte copy of the JAX package's fit (its harness fits them against
# the pallas kernels' measured bytes/FLOPs). The port's own refit on the card
# (``calibrate/calibrated_h100.json``) stands beside it and is not read here.
# Every fitted constant multiplies a term that is EXACTLY zero at the INT8
# anchor, so refitting never moves an int8 corner (the anchor invariant).
_CALIBRATED_DEFAULTS = {
    # multiplier share of the INT8 MAC energy: partial-product bit-work
    # (8x8 = 64 bit-products) vs the fixed 32-bit accumulate
    "mac_mul_share": 64.0 / 96.0,
    # fraction of the operand-delivery cost that scales with the operand
    # pair width (w+a bits of wires/collector flops per MAC)
    "delivery_width_frac": 0.5,
}

_CALIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, "calibrate", "calibrated.json")


def load_calibrated(path: str = _CALIB_PATH) -> Dict[str, float]:
    """Fitted compute-plane constants from the checked-in calibration JSON,
    falling back to the structural defaults (missing file, partial fit)."""
    out = dict(_CALIBRATED_DEFAULTS)
    with contextlib.suppress(OSError, ValueError), open(path) as f:
        data = json.load(f)
        for k, v in data.get("constants", {}).items():
            if k in out:
                out[k] = float(v)
    return out


CALIBRATED = load_calibrated()

# Energy of the EXCESS multiplier bit-work per `mac_mul_units` unit (one
# unit == the whole int8 partial-product array). Exactly unused at int8.
MAC_MUL_PJ_45 = CALIBRATED["mac_mul_share"] * MAC_INT8_PJ_45


def mac_mul_units(weight_bits, act_bits):
    """Excess multiplier bit-work per MAC vs the INT8 anchor, elementwise:
    ``w*a/64 - 1`` (quadratic-in-bits partial-product count; exactly 0.0
    at int8, negative for narrower operands)."""
    w = np.asarray(weight_bits, float)
    a = np.asarray(act_bits, float)
    return w * a / 64.0 - 1.0


def delivery_width_units(weight_bits, act_bits):
    """Excess operand-pair delivery width per MAC vs INT8, elementwise:
    ``(w+a)/16 - 1`` (exactly 0.0 at int8)."""
    w = np.asarray(weight_bits, float)
    a = np.asarray(act_bits, float)
    return (w + a) / 16.0 - 1.0


@dataclasses.dataclass(frozen=True)
class ComputeSpec:
    """Precision-aware PE datapath archetype — STRUCTURE only (the energy
    constants above stay module-level so calibration/grid-search mutation
    is honored by cached plans; DESIGN.md §6).

    ``lane_bits`` is one PE lane's operand width at the INT8 anchor;
    narrower operands split each lane into ``lane_bits // width`` sub-lanes
    (SIMD lane splitting à la XR-NPE), wider operands fuse lanes. ``two_dim``
    engines split on weight and activation widths INDEPENDENTLY (a 2D
    multiplier array: w4a8 already doubles throughput); 1D engines split on
    the widest operand only. Frozen + hashable: lives on ``ArchSpec`` and
    flows through every arch cache key.
    """
    archetype: str
    lane_bits: int = 8
    two_dim: bool = False

    def _split1(self, bits):
        b = np.maximum(np.asarray(bits, float), 1.0)
        lanes = np.floor(self.lane_bits / b)
        return np.where(lanes >= 1.0, lanes, 1.0 / np.ceil(b / self.lane_bits))

    def macs_per_pe_per_cycle(self, weight_bits=8, act_bits=8):
        """Throughput multiplier vs the INT8 anchor, elementwise (exactly
        1.0 at int8 by construction; >1 for narrower operands)."""
        anchor = self._split1(8.0)
        if self.two_dim:
            return (self._split1(weight_bits) * self._split1(act_bits)
                    / (anchor * anchor))
        wide = np.maximum(np.asarray(weight_bits, float),
                          np.asarray(act_bits, float))
        return self._split1(wide) / anchor


COMPUTE_ARCHETYPES: Dict[str, ComputeSpec] = {
    # fixed-function MAC array: int8 lanes, sub-byte operands packed 1D
    "systolic": ComputeSpec("systolic", lane_bits=8),
    # 64-bit SIMD datapath: 8 int8 MACs/cycle at the anchor, 16 at int4
    "cpu-simd": ComputeSpec("cpu-simd", lane_bits=64),
    # XR-NPE-style 2D mixed-precision array: w4a8 doubles, int4 quadruples
    "xr-npe": ComputeSpec("xr-npe", lane_bits=8, two_dim=True),
}


def mac_energy_pj(node: int, cls: str = "systolic", bits=8,
                  compute: ComputeSpec = None) -> float:
    """Per-MAC energy at (node, arch class, operand widths). ``bits`` is a
    single width or a ``(weight_bits, act_bits)`` pair; the CPU class pays
    the per-issue overhead amortized over its lane split (``compute``
    defaults to the class archetype)."""
    wb, ab = bits if isinstance(bits, (tuple, list)) else (bits, bits)
    e = MAC_INT8_PJ_45 + MAC_MUL_PJ_45 * float(mac_mul_units(wb, ab))
    if cls == "cpu":
        spec = compute or COMPUTE_ARCHETYPES["cpu-simd"]
        e += (CPU_OP_OVERHEAD_PJ_45
              / float(spec.macs_per_pe_per_cycle(wb, ab)))
    return e * NODE_ENERGY_SCALE[node]


def clock_ghz(node: int, cls: str) -> float:
    return BASE_CLOCK_GHZ_45[cls] / NODE_DELAY_SCALE[node]


def compute_area_mm2(num_macs: int, node: int) -> float:
    return num_macs * MAC_AREA_UM2_45 * NODE_AREA_SCALE[node] / 1e6


# ---------------------------------------------------------------------------
# power-gating model (paper §5)
# ---------------------------------------------------------------------------

STANDBY_CURRENT_RATIO = 100.0   # standby current 100x below read current [11]
WAKEUP_TIME_S = 100e-6          # accelerator wake-up time

# ---------------------------------------------------------------------------
# multi-stream (time-shared) system model (core.schedule)
# ---------------------------------------------------------------------------

# Off-module weight staging for a context switch. The paper's design is
# DRAM-free: the on-chip weight buffer IS the backing store for ONE
# workload's weights, so when a time-shared accelerator switches to a
# workload whose weights are not retained on chip, they must be re-fetched
# over the host/flash link (LPDDR/NOR-class: device + PHY + controller,
# ~tens of pJ/bit; node-independent — IO interconnect does not scale with
# the logic node). Non-volatile weight levels retain through both power-off
# and context switches, which is where MRAM residency "pays twice".
WEIGHT_STAGE_PJ_PER_BIT = 20.0
