"""Timeloop-lite: map a conv/dense workload onto an ArchSpec and emit
per-level access counts.

Counts are *variant-independent* (tiling is set by buffer capacities, which
P0/P1 do not change); the energy/latency roll-up (core.energy) prices the
same counts under each memory technology. This mirrors the paper's flow:
Timeloop produces operation counts once, Accelergy prices them per variant.

Dataflow asymmetries reproduced (the paper's central mechanics):

  * ``weight`` (Simba): weights are PINNED — fetched from the global weight
    buffer exactly once per inference into per-PE weight buffers, then held
    in MAC operand registers across all spatial reuse. Inputs re-stream once
    per weight tile; partial sums spill to the accumulation buffer once per
    reduction tile.
  * ``row`` (Eyeriss): activations are resident in the global buffer; filter
    rows stream into SMALL per-PE weight spads and are re-fetched per output
    row-strip; crucially the spad is read EVERY MAC (it is an SRAM macro, not
    a pipeline register) — this is why MRAM weight memory hurts Eyeriss
    (paper Table 3, negative P0 savings) while Simba barely notices.
  * ``sequential`` (CPU): compulsory traffic only (weights/inputs once,
    outputs once) — compute-dominated, matching Fig 2(e).

Operand *delivery* energy (array NoC + operand collectors) is tracked as a
per-MAC fixed-class cost: it contributes to the memory share of Fig 2(e) but
is register-level hardware that no P0/P1 variant converts to MRAM.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.base import ConvLayerSpec
from repro_torch.core import devices as dev
from repro_torch.core.archspec import ArchSpec

# Operand widths live on ``ConvLayerSpec`` (``weight_bits`` / ``act_bits``
# / derived ``psum_width``, INT8 defaults): the mappers read the PER-LAYER
# widths so mixed-precision workloads price every operand at its stored
# width. The MAC array is precision-aware too (DESIGN.md §10): each arch's
# ``compute`` archetype (devices.ComputeSpec) sets a per-layer lane split
# that the mappers bake into compute_cycles — exactly 1.0 at the INT8
# anchor, so int8 mappings are bit-identical to the fixed-datapath model.
CPU_SIMD = 8            # 64-bit datapath -> 8 INT8 MACs/cycle @ the anchor
# Operand delivery (array NoC hops + operand-collector regfiles) per MAC,
# pJ @ 45nm. Long wires across a 64x64 array make this the dominant "memory"
# cost of the systolic designs (paper Fig 2e: memory >> compute; Fig 2f:
# systolic energy above the sequential CPU despite the latency win).
DELIVERY_PJ_PER_MAC_45 = 0.55
CPU_DELIVERY_PJ_PER_MAC_45 = 0.10   # load-store forwarding within the core
# Fraction of the delivery cost that scales with the operand-pair width
# ((w+a) bits of wires/collector flops per MAC); the remainder is fixed
# control/handshake. Fitted by the JAX package's harness against the pallas
# kernels' measured byte counts; multiplies ``devices.delivery_width_units``
# which is exactly 0.0 at int8 (anchor invariant).
DELIVERY_WIDTH_FRAC = dev.CALIBRATED["delivery_width_frac"]


@dataclass
class LevelTraffic:
    read_bits: float = 0.0
    write_bits: float = 0.0


@dataclass
class LayerAccess:
    """Access counts for one layer mapped onto one architecture."""
    name: str
    macs: int
    traffic: Dict[str, LevelTraffic]       # level name -> bits moved
    compute_cycles: float
    delivery_macs: int                     # MACs paying the delivery cost
    weight_bits: int = 8                   # operand widths the layer was
    act_bits: int = 8                      # mapped at (compute pricing)

    def total_read_bits(self) -> float:
        return sum(t.read_bits for t in self.traffic.values())

    def total_write_bits(self) -> float:
        return sum(t.write_bits for t in self.traffic.values())


def _ceil(a: float, b: float) -> int:
    return int(math.ceil(a / b))


# ---------------------------------------------------------------------------
# per-dataflow mappers
# ---------------------------------------------------------------------------

def _lane_split(spec: ConvLayerSpec, arch: ArchSpec) -> float:
    """Per-layer SIMD lane split of the arch's compute archetype (1.0 at
    the INT8 anchor — see ``devices.ComputeSpec``)."""
    return float(arch.compute.macs_per_pe_per_cycle(spec.weight_bits,
                                                    spec.act_bits))


def _map_sequential(spec: ConvLayerSpec, arch: ArchSpec) -> LayerAccess:
    t = {l.name: LevelTraffic() for l in arch.levels}
    t["weight_mem"].read_bits = spec.weight_elems * spec.weight_bits
    t["act_mem"].read_bits = spec.in_elems * spec.act_bits
    t["act_mem"].write_bits = spec.out_elems * spec.act_bits
    cycles = spec.macs / (CPU_SIMD * _lane_split(spec, arch))
    return LayerAccess(spec.name, spec.macs, t, cycles, spec.macs,
                       spec.weight_bits, spec.act_bits)


def _act_refetch(spec: ConvLayerSpec, act_capacity_kb: float) -> int:
    """Layers whose input exceeds the act buffer stream in row tiles; halo
    and weight-pass overlap re-reads grow with the number of tiles."""
    return max(1, _ceil(spec.in_bytes / 1024.0, max(act_capacity_kb, 1.0)))


def _map_weight_stationary(spec: ConvLayerSpec, arch: ArchSpec) -> LayerAccess:
    t = {l.name: LevelTraffic() for l in arch.levels}
    W = spec.weight_elems * spec.weight_bits
    I = spec.in_elems * spec.act_bits
    O = spec.out_elems
    wb_bits = arch.level("pe_wb").capacity_bits

    n_wtiles = max(1, _ceil(W, wb_bits))
    # Weight residency: when the full model fits the aggregate per-PE weight
    # buffers, weights are written ONCE at boot and retained across
    # inferences (NVM retains through power-off; SRAM retains in drowsy
    # standby) — the paper's "weight memory could be optimized" observation.
    resident = n_wtiles == 1
    # output-channel passes: 64 output lanes hold K channels concurrently;
    # inputs re-stream once per K-group
    n_kpasses = max(1, _ceil(spec.out_ch, arch.pe_x))
    if spec.kind == "dwconv":
        n_kpasses = 1
    refetch = _act_refetch(spec, arch.level("input_buf").capacity_kb)
    # reduction tiling: psums spill once per input-channel/window group that
    # exceeds the array's spatial reduction capacity (pe_x scalar lanes)
    reduce_cap = arch.pe_x
    red = 1 if spec.kind == "dwconv" else spec.in_ch * spec.kernel * spec.kernel
    n_ctiles = max(1, _ceil(red, reduce_cap))

    if not resident:                               # per-inference streaming
        t["gwb"].read_bits = W
        t["pe_wb"].write_bits = W
    t["pe_wb"].read_bits = W                       # into MAC operand regs once
    t["input_buf"].write_bits = I * refetch        # tiled fill (halo re-reads)
    t["input_buf"].read_bits = I * max(n_wtiles, n_kpasses) * refetch
    t["accum_buf"].write_bits = O * spec.psum_width * n_ctiles
    t["accum_buf"].read_bits = O * spec.psum_width * n_ctiles  # revisits + drain

    cycles = spec.macs / (arch.num_pes * _lane_split(spec, arch))
    return LayerAccess(spec.name, spec.macs, t, cycles, spec.macs,
                       spec.weight_bits, spec.act_bits)


def _map_row_stationary(spec: ConvLayerSpec, arch: ArchSpec) -> LayerAccess:
    t = {l.name: LevelTraffic() for l in arch.levels}
    W = spec.weight_elems * spec.weight_bits
    I = spec.in_elems * spec.act_bits
    O = spec.out_elems
    oh, ow = spec.out_hw

    # output row-strips per pass; filters re-fetched per strip
    n_strips = max(1, _ceil(oh, arch.pe_y))
    # filters processed concurrently: array rows host `kernel` filter rows;
    # the ifmap is re-streamed from the glb once per resident filter group
    k_par = max(1, arch.pe_x // max(1, spec.kernel))
    n_ktiles = max(1, _ceil(spec.out_ch, k_par))

    refetch = _act_refetch(spec, arch.level("glb").capacity_kb)

    t["gwb"].read_bits = W * n_strips
    t["pe_spad"].write_bits = W * n_strips
    t["pe_spad"].read_bits = spec.macs * spec.weight_bits  # spad read EVERY MAC
    # row-stationary keeps psums INSIDE the array (cross-PE accumulation);
    # the glb sees ifmap streams (read-heavy) plus a single psum drain.
    t["glb"].write_bits = I * refetch + O * spec.psum_width
    t["glb"].read_bits = I * n_ktiles * refetch

    cycles = spec.macs / (arch.num_pes * _lane_split(spec, arch))
    return LayerAccess(spec.name, spec.macs, t, cycles, spec.macs,
                       spec.weight_bits, spec.act_bits)


_MAPPERS = {
    "sequential": _map_sequential,
    "weight": _map_weight_stationary,
    "row": _map_row_stationary,
}


def map_layer(spec: ConvLayerSpec, arch: ArchSpec) -> LayerAccess:
    return _MAPPERS[arch.dataflow](spec, arch)


def map_workload(specs: Sequence[ConvLayerSpec], arch: ArchSpec
                 ) -> List[LayerAccess]:
    return [map_layer(s, arch) for s in specs]


def map_workload_columns(specs: Sequence[ConvLayerSpec], arch: ArchSpec):
    """Vectorized mapper: all layers in array ops -> ``TrafficTable``
    (the columnar path; ``map_workload`` stays the scalar oracle)."""
    from repro_torch.core import columns
    return columns.TrafficTable.map_specs(specs, arch)


# ---------------------------------------------------------------------------
# workload-level aggregates
# ---------------------------------------------------------------------------

def total_traffic(accesses: Sequence[LayerAccess]) -> Dict[str, LevelTraffic]:
    out: Dict[str, LevelTraffic] = {}
    for a in accesses:
        for lvl, tr in a.traffic.items():
            agg = out.setdefault(lvl, LevelTraffic())
            agg.read_bits += tr.read_bits
            agg.write_bits += tr.write_bits
    return out


def total_macs(accesses: Sequence[LayerAccess]) -> int:
    return sum(a.macs for a in accesses)


def required_weight_kb(specs: Sequence[ConvLayerSpec]) -> float:
    """Global weight buffer sizing rule: full model at its stored weight
    width (DRAM-free); INT4 weights halve the requirement."""
    return sum(s.weight_bytes for s in specs) / 1024.0


def required_act_kb(specs: Sequence[ConvLayerSpec]) -> float:
    """Activation buffer sizing rule: largest layer in+out working set at
    the stored activation width."""
    return max((s.in_bytes + s.out_bytes) for s in specs) / 1024.0
