"""System-level scheduling: concurrent workloads time-multiplexed on ONE
accelerator (DESIGN.md §7 §System).

The paper prices hand detection (IPS=10) and eye segmentation (IPS=0.1) as
isolated pipelines, but a real XR device runs both on one accelerator —
exactly the regime where MRAM residency pays twice (no standby power AND no
weight reload on a context switch, as in Siracusa's at-MRAM neural engine).
This module opens that system-level axis on top of the existing
arch/node/placement/precision axes:

  * ``Stream``      — one periodic workload on the shared accelerator:
                      (workload, target IPS, operand widths).
  * ``SystemPoint`` — a tuple of streams plus ONE shared
                      (arch, node, placement, pe_config) and a weight-buffer
                      contention ``mode``.
  * ``SystemTable`` — every system priced by time-multiplexing the
                      per-stream ``EnergyTable`` rows the columnar engine
                      already produces (one vectorized pass for all streams
                      of all systems); ``row(i)`` materializes the scalar
                      ``SystemReport`` view.

Temporal model (single-stream gating model of ``core.nvm`` generalized):

    duty_i    = ips_i * latency_i          (stream compute windows)
    D         = sum_i duty_i               (aggregate duty; feasible iff <= 1
                                            — each stream then also meets its
                                            own IPS, since duty_i <= D)
    idle      = max(0, 1 - D)              (shared standby window)
    R         = sum_i ips_i                (aggregate inference rate)

    P_mem = sum_i ips_i * E_mem_i          (per-stream inference energy)
          + idle * P_standby               (ONE shared hierarchy idles)
          + R * idle * E_wake              (wake per gating EVENT)
          + sum_i switch_rate_i * E_reload_i   (mode="reload" only)

Weight-buffer contention between streams is resolved one of two ways:

  * ``mode="reload"`` — the weight buffer is sized for the LARGEST stream
    (the paper's one-silicon max rule) and holds only the active stream's
    weights. Each switch INTO stream i re-stages its weights: a write into
    every VOLATILE weight-class level (non-volatile levels retain through
    the switch — the MRAM win), plus an off-module fetch
    (``devices.WEIGHT_STAGE_PJ_PER_BIT``, the design is DRAM-free) when no
    non-volatile weight level retains them on chip. Switches into stream i
    happen at ``min(ips_i, sum_{j != i} ips_j)`` per second: a batching
    scheduler runs each stream's due inferences back to back, so a 10-IPS
    stream sharing with a 0.1-IPS stream is preempted (and reloaded) only
    0.1 times per second.
  * ``mode="union"``  — the weight buffer is sized for the SUM of the
    streams' weight footprints, so every stream stays resident: no reload
    energy, but a bigger buffer (area + standby cost, priced through the
    normal geometry path via ``size_arch``).

A single-stream ``SystemPoint`` reduces exactly to the existing
``nvm.memory_power_w`` path (switch rate 0, sizing = the workload's own) —
that parity is the correctness oracle (``tests/test_schedule.py``).

Pricing functions take an ``experiment.Evaluator`` (imported lazily to keep
this module cycle-free); ``Evaluator.system_table``/``system_rows`` are the
cached entry points.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import columns
from repro_torch.core import devices as dev
from repro_torch.core.dataflow import required_act_kb, required_weight_kb
from repro_torch.core.energy import EnergyReport
from repro_torch.core.placement import Placement
from repro_torch.core.space import DesignPoint

MODES = ("reload", "union")


# ---------------------------------------------------------------------------
# Stream / SystemPoint
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Stream:
    """One periodic workload on the shared accelerator."""
    workload: Any
    ips: float
    weight_bits: Optional[int] = None   # None -> spec default (INT8)
    act_bits: Optional[int] = None
    psum_bits: Optional[int] = None
    extract_kw: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if not self.ips > 0.0:
            raise ValueError(f"Stream({self.name!r}): ips must be > 0, "
                             f"got {self.ips!r}")
        if not math.isfinite(self.ips):
            raise ValueError(f"Stream({self.name!r}): ips must be finite, "
                             f"got {self.ips!r}")
        if isinstance(self.extract_kw, dict):
            object.__setattr__(self, "extract_kw",
                               tuple(sorted(self.extract_kw.items())))

    @property
    def name(self) -> str:
        if isinstance(self.workload, str):
            return self.workload
        return getattr(self.workload, "name", "custom")

    def precision(self) -> Tuple[Optional[int], Optional[int], Optional[int]]:
        return (self.weight_bits, self.act_bits, self.psum_bits)


class _Unset:
    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()


@dataclass(frozen=True)
class SystemPoint:
    """Streams time-multiplexed on one (arch, node, placement) accelerator.

    The technology trio (``variant``/``nvm``/``placement``) canonicalizes
    exactly like ``DesignPoint``'s: ``placement`` is authoritative, the
    legacy kwargs are accepted and folded in, and after construction
    ``variant`` holds the placement label and ``nvm`` its bound device.
    ``mode`` picks the weight-buffer contention resolution (see module
    docstring); it is part of equality/hash because it changes the sized
    hardware, not just the pricing.
    """
    streams: Tuple[Stream, ...]
    arch: str
    node: int
    variant: Any = None
    nvm: Any = _UNSET
    pe_config: str = "v2"
    mode: str = "reload"
    placement: Optional[Placement] = None

    def __post_init__(self):
        if isinstance(self.streams, Stream):
            object.__setattr__(self, "streams", (self.streams,))
        else:
            object.__setattr__(self, "streams", tuple(self.streams))
        if not self.streams:
            raise ValueError("SystemPoint needs at least one stream")
        dups = [n for n, c in Counter(s.name for s in self.streams).items()
                if c > 1]
        if dups:
            # two same-name streams would alias in reload accounting and in
            # every by-name roll-up (scenario rates, trace tracks)
            raise ValueError(
                f"SystemPoint: duplicate stream workload name(s) "
                f"{sorted(dups)!r} — each stream must be a distinct "
                f"workload")
        if self.mode not in MODES:
            raise ValueError(f"SystemPoint: unknown mode {self.mode!r} "
                             f"(one of {MODES})")
        pl, v, n = self.placement, self.variant, self.nvm
        if isinstance(v, Placement):
            if pl is not None and pl != v:
                raise TypeError("SystemPoint: got two different placements "
                                "(via variant= and placement=)")
            pl, v = v, None
        if pl is None:
            pl = Placement.variant(v or "sram", None if n is _UNSET else n)
        elif v is not None and v != pl.label:
            pl = Placement.variant(v, pl.nvm if n is _UNSET else n)
        elif n is not _UNSET and n != pl.nvm:
            pl = pl.with_nvm(n)
        object.__setattr__(self, "placement", pl)
        object.__setattr__(self, "variant", pl.label)
        object.__setattr__(self, "nvm", pl.nvm)

    # --- convenience --------------------------------------------------------
    def with_(self, **changes) -> "SystemPoint":
        if "placement" in changes:
            changes.setdefault("variant", None)
            changes.setdefault("nvm", _UNSET)
        return replace(self, **changes)

    @property
    def workload_name(self) -> str:
        return "+".join(s.name for s in self.streams)

    def arch_spec(self):
        """Unsized ``ArchSpec`` for the shared accelerator (same cpu
        asymmetry rule as ``DesignPoint.arch_spec``) — what placement
        selectors and hillclimb moves resolve level names against."""
        from repro_torch.core.archspec import get_arch
        if self.arch == "cpu":
            return get_arch("cpu")
        return get_arch(self.arch, pe_config=self.pe_config)

    @property
    def ips(self) -> Tuple[float, ...]:
        return tuple(s.ips for s in self.streams)

    def stream_points(self) -> List[DesignPoint]:
        """Per-stream ``DesignPoint``s sharing this system's accelerator.

        ``suite=None``: system buffer sizing is handled explicitly by
        ``system_sizing`` (max/union over THIS system's streams), not by the
        per-point suite rule."""
        return [DesignPoint(
            workload=s.workload, arch=self.arch, node=self.node,
            placement=self.placement, pe_config=self.pe_config, suite=None,
            extract_kw=s.extract_kw, weight_bits=s.weight_bits,
            act_bits=s.act_bits, psum_bits=s.psum_bits)
            for s in self.streams]


# ---------------------------------------------------------------------------
# sizing + geometry (structural; cached by the Evaluator)
# ---------------------------------------------------------------------------


def system_sizing(ev, spoint: SystemPoint) -> Tuple[float, float, np.ndarray]:
    """(weight_kb, act_kb, per-stream weight footprint bits) for one system.

    ``mode="reload"``: weight buffer holds the largest stream (the paper's
    one-silicon max rule); ``mode="union"``: all streams resident at once,
    so the footprints ADD. Activations are transient (one stream computes at
    a time), so the act buffer takes the max in both modes."""
    from repro_torch.core.experiment import ACT_CAP_KB
    w_list, a_list = [], []
    for s in spoint.streams:
        specs = ev.specs(s.workload, s.extract_kw, bits=s.precision())
        w_list.append(required_weight_kb(specs))
        a_list.append(required_act_kb(specs))
    w_kb = sum(w_list) if spoint.mode == "union" else max(w_list)
    a_kb = min(ACT_CAP_KB, max(a_list))
    w_bits = np.array(w_list, float) * 1024.0 * 8.0
    return w_kb, a_kb, w_bits


@dataclass(frozen=True)
class SystemGeometry:
    """Device-constant-free flattening of a list of ``SystemPoint``s: the
    per-stream rows as ONE ``PricingPlan`` plus the stream -> system index
    maps. Re-pricing after a device-table mutation reuses it untouched
    (same contract as ``columns.PricingPlan``)."""
    spoints: Tuple[SystemPoint, ...]
    plan: columns.PricingPlan           # one row per (system, stream)
    sys_idx: np.ndarray                 # (R,) stream row -> system index
    ips: np.ndarray                     # (R,) per-stream target rate
    weight_bits: np.ndarray             # (R,) stream weight footprint, bits
    is_union: np.ndarray                # (S,) bool

    def __post_init__(self) -> None:
        columns.freeze_arrays(self)

    @property
    def n_systems(self) -> int:
        return len(self.spoints)


def system_geometry(ev, spoints: Sequence[SystemPoint]) -> SystemGeometry:
    """Flatten systems to per-stream rows on their shared sized archs.

    All structural work routes through the Evaluator's caches (specs,
    sized arch, traffic) and the shared plan assembly
    (``Evaluator.assemble_plan``), so a placement lattice over the same
    stream bundle costs one mapping per (workload, sized arch) pair."""
    spoints = tuple(spoints)
    pairs: List[Tuple[DesignPoint, Any]] = []
    sys_idx: List[int] = []
    ips: List[float] = []
    wbits: List[float] = []
    for si, sp in enumerate(spoints):
        w_kb, a_kb, w_bits = system_sizing(ev, sp)
        base = ev.sized_arch(sp.arch, sp.pe_config, w_kb, a_kb)
        for dp, s, wb in zip(sp.stream_points(), sp.streams, w_bits):
            pairs.append((dp, base))
            sys_idx.append(si)
            ips.append(s.ips)
            wbits.append(wb)
    plan = ev.assemble_plan(pairs, default="stt")
    return SystemGeometry(
        spoints, plan, np.asarray(sys_idx, int), np.asarray(ips, float),
        np.asarray(wbits, float),
        np.array([sp.mode == "union" for sp in spoints]))


# ---------------------------------------------------------------------------
# pricing (device tables re-read every call)
# ---------------------------------------------------------------------------


def reload_energy_j(geom: SystemGeometry,
                    table: columns.EnergyTable) -> np.ndarray:
    """(R,) energy to re-stage each stream's weights on a switch INTO it.

    Writes the stream's resident footprint — ``min(W_bits, capacity)`` per
    level — into every VOLATILE weight-class level at the same unit write
    cost inference traffic pays, plus the off-module fetch
    (``devices.WEIGHT_STAGE_PJ_PER_BIT`` x W_bits) when NO non-volatile
    weight level retains the weights on chip. Union-mode systems and
    all-NVM weight hierarchies therefore charge zero."""
    plan = geom.plan
    _, ew = columns.unit_energy_pj_per_bit(plan)            # (R, L)
    volatile_mask = plan.mask & plan.weight_cls & ~table.nonvolatile
    cap_bits = plan.capacity_kb * 1024.0 * 8.0
    resident = np.minimum(geom.weight_bits[:, None], cap_bits)
    write_pj = (resident * ew * volatile_mask).sum(axis=1)
    retained = (plan.weight_cls & table.nonvolatile).any(axis=1)
    stage_pj = np.where(retained, 0.0,
                        geom.weight_bits * dev.WEIGHT_STAGE_PJ_PER_BIT)
    return (write_pj + stage_pj) * 1e-12


def switch_rate_at(sys_idx: np.ndarray, ips: np.ndarray,
                   is_union_rows: np.ndarray, n_systems: int) -> np.ndarray:
    """(R',) context switches INTO each stream row per second at the given
    rates.

    A batching scheduler runs each stream's due inferences back to back:
    stream i is switched into ``min(ips_i, sum_{j != i} ips_j)`` times per
    second (a single stream is never switched — the single-stream parity
    anchor; a stream idle this window, ips=0, is never switched INTO).
    Union-mode streams stay resident: rate 0."""
    total = np.bincount(sys_idx, weights=ips, minlength=n_systems)
    rate = np.minimum(ips, total[sys_idx] - ips)
    return np.where(is_union_rows, 0.0, np.maximum(0.0, rate))


def switch_rate(geom: SystemGeometry) -> np.ndarray:
    """(R,) switch rates at the geometry's own steady-state stream rates."""
    return switch_rate_at(geom.sys_idx, geom.ips,
                          geom.is_union[geom.sys_idx], geom.n_systems)


@dataclass(frozen=True)
class SystemTable:
    """All per-system power/feasibility columns, plus the per-stream
    ``EnergyTable`` they were rolled up from (its rows are the plan's
    (system, stream) flattening — ``geometry.sys_idx`` maps back)."""
    geometry: SystemGeometry
    energy: columns.EnergyTable          # per-stream rows
    # per-stream columns (R,)
    stream_duty: np.ndarray
    stream_dyn_w: np.ndarray             # ips * E_mem
    switch_rate: np.ndarray              # switches into the stream / s
    reload_j: np.ndarray                 # energy per switch into the stream
    # per-system columns (S,)
    duty: np.ndarray                     # aggregate duty sum
    feasible: np.ndarray                 # bool: duty <= 1
    standby_w: np.ndarray
    wake_j: np.ndarray
    wake_rate: np.ndarray                # gating events / s
    dyn_w: np.ndarray
    reload_w: np.ndarray
    p_mem_w: np.ndarray                  # the system memory power

    def __post_init__(self) -> None:
        columns.freeze_arrays(self)

    def __len__(self) -> int:
        return self.geometry.n_systems

    @property
    def points(self) -> Tuple[SystemPoint, ...]:
        return self.geometry.spoints

    def row(self, i: int) -> "SystemReport":
        g = self.geometry
        rows = np.flatnonzero(g.sys_idx == i)
        shares = tuple(StreamShare(
            stream=g.spoints[i].streams[k],
            report=self.energy.row(int(r)),
            duty=float(self.stream_duty[r]),
            switch_rate=float(self.switch_rate[r]),
            reload_j=float(self.reload_j[r]))
            for k, r in enumerate(rows))
        return SystemReport(
            point=g.spoints[i], shares=shares,
            duty=float(self.duty[i]), feasible=bool(self.feasible[i]),
            standby_w=float(self.standby_w[i]), wake_j=float(self.wake_j[i]),
            wake_rate=float(self.wake_rate[i]), dyn_w=float(self.dyn_w[i]),
            reload_w=float(self.reload_w[i]),
            p_mem_w=float(self.p_mem_w[i]))

    def rows(self) -> List["SystemReport"]:
        return [self.row(i) for i in range(len(self))]


@dataclass(frozen=True)
class StreamShare:
    """One stream's slice of a priced system (scalar view)."""
    stream: Stream
    report: EnergyReport
    duty: float
    switch_rate: float
    reload_j: float


@dataclass(frozen=True)
class SystemReport:
    """Scalar view of one priced ``SystemPoint`` (``SystemTable.row``)."""
    point: SystemPoint
    shares: Tuple[StreamShare, ...]
    duty: float
    feasible: bool
    standby_w: float
    wake_j: float
    wake_rate: float
    dyn_w: float
    reload_w: float
    p_mem_w: float

    @property
    def idle_frac(self) -> float:
        return max(0.0, 1.0 - self.duty)

    @property
    def memory_power_w(self) -> float:
        return self.p_mem_w


def _rollup(sys_idx: np.ndarray, ips: np.ndarray, is_union_rows: np.ndarray,
            S: int, e_mem_j: np.ndarray, e_compute_j: np.ndarray,
            latency_s: np.ndarray, standby_w: np.ndarray,
            wake_j: np.ndarray, rel_j: np.ndarray) -> Dict[str, np.ndarray]:
    """The time-multiplexing roll-up at EXPLICIT per-row rates.

    All per-stream inputs are row vectors aligned with ``sys_idx`` (which
    maps row -> virtual system in [0, S)). ``price`` calls this once with
    the geometry's steady-state rates; ``window_rollup`` calls it with the
    rows TILED over a window axis — the per-bin accumulation order of each
    ``bincount`` is then identical to the single-window case, which is what
    makes a constant-rate trace window byte-identical to the steady-state
    system report (the trace parity oracle)."""
    stream_duty = ips * latency_s
    stream_dyn_w = ips * e_mem_j
    duty = np.bincount(sys_idx, weights=stream_duty, minlength=S)
    dyn_w = np.bincount(sys_idx, weights=stream_dyn_w, minlength=S)
    compute_w = np.bincount(sys_idx, weights=ips * e_compute_j, minlength=S)
    total_ips = np.bincount(sys_idx, weights=ips, minlength=S)
    idle = np.maximum(0.0, 1.0 - duty)
    feasible = duty <= 1.0

    # all streams of a system share one hierarchy: standby/wake are
    # per-SYSTEM quantities, identical on every stream row — gather from
    # the first row of each system.
    first = np.zeros(S, int)
    first[sys_idx[::-1]] = np.arange(len(sys_idx))[::-1]
    standby_w = standby_w[first]
    wake_j = wake_j[first]
    wake_rate = total_ips * idle

    sw_rate = switch_rate_at(sys_idx, ips, is_union_rows, S)
    reload_w = np.bincount(sys_idx, weights=sw_rate * rel_j, minlength=S)

    p_mem_w = dyn_w + idle * standby_w + wake_rate * wake_j + reload_w
    return dict(stream_duty=stream_duty, stream_dyn_w=stream_dyn_w,
                switch_rate=sw_rate, duty=duty, feasible=feasible,
                standby_w=standby_w, wake_j=wake_j, wake_rate=wake_rate,
                dyn_w=dyn_w, compute_w=compute_w, reload_w=reload_w,
                p_mem_w=p_mem_w)


def price(geom: SystemGeometry) -> SystemTable:
    """Roll per-stream ``EnergyTable`` rows up to system memory power.

    Device constants are re-read on every call (the energy pricing, unit
    write costs and the staging constant), so calibration tools may mutate
    ``core.devices`` between calls and reuse a cached geometry."""
    table = columns.price(geom.plan)
    rel_j = reload_energy_j(geom, table)
    c = _rollup(geom.sys_idx, geom.ips, geom.is_union[geom.sys_idx],
                geom.n_systems, table.mem_pj * 1e-12,
                table.compute_pj * 1e-12, table.latency_s, table.standby_w,
                table.wake_energy_j, rel_j)
    return SystemTable(
        geometry=geom, energy=table, stream_duty=c["stream_duty"],
        stream_dyn_w=c["stream_dyn_w"], switch_rate=c["switch_rate"],
        reload_j=rel_j, duty=c["duty"], feasible=c["feasible"],
        standby_w=c["standby_w"], wake_j=c["wake_j"],
        wake_rate=c["wake_rate"], dyn_w=c["dyn_w"], reload_w=c["reload_w"],
        p_mem_w=c["p_mem_w"])


# ---------------------------------------------------------------------------
# window pricing hook (trace-driven simulation; repro.trace)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WindowColumns:
    """Per-(window, system) roll-up of one geometry at W rate vectors.

    The rate-INDEPENDENT work (columnar ``EnergyTable`` pricing, reload
    energies) is done once; only the cheap roll-up arithmetic carries the
    window axis. Shapes: (W, S) per system, (W, R) per stream row, (R,)
    rate-independent, where R = number of stream rows in the geometry."""
    geometry: SystemGeometry
    energy: columns.EnergyTable
    rates: np.ndarray           # (W, R) the rates each window was priced at
    reload_j: np.ndarray        # (R,)  energy per switch into the stream
    stream_duty: np.ndarray     # (W, R)
    stream_dyn_w: np.ndarray    # (W, R)
    switch_rate: np.ndarray     # (W, R)
    duty: np.ndarray            # (W, S)
    feasible: np.ndarray        # (W, S) bool
    standby_w: np.ndarray       # (W, S)
    wake_j: np.ndarray          # (W, S)
    wake_rate: np.ndarray       # (W, S)
    dyn_w: np.ndarray           # (W, S)
    compute_w: np.ndarray       # (W, S) dynamic compute power (battery view)
    reload_w: np.ndarray        # (W, S)
    p_mem_w: np.ndarray         # (W, S)

    def __post_init__(self) -> None:
        columns.freeze_arrays(self)

    @property
    def n_windows(self) -> int:
        return self.rates.shape[0]

    @property
    def idle_frac(self) -> np.ndarray:  # (W, S)
        return np.maximum(0.0, 1.0 - self.duty)

    @property
    def p_total_w(self) -> np.ndarray:  # (W, S) memory + dynamic compute
        return self.p_mem_w + self.compute_w


def window_rollup(geom: SystemGeometry, rates,
                  table: Optional[columns.EnergyTable] = None
                  ) -> WindowColumns:
    """Price W rate windows of one geometry in ONE vectorized roll-up.

    ``rates`` is (W, R): each row is a full per-stream rate vector (0.0 =
    the stream is off that window — it contributes no duty, no dynamic
    energy and is never switched into). Every (window, system) cell is
    priced exactly as a steady-state system at that window's rates: the
    window axis is flattened into W*S virtual systems and pushed through
    the SAME roll-up ``price`` uses, so a window whose rates equal the
    geometry's steady-state rates reproduces ``price(geom)`` byte-for-byte
    (the trace parity oracle). The expensive rate-independent columns
    (``EnergyTable``, reload energies) are computed once, not per window;
    pass ``table`` to reuse an already-priced EnergyTable."""
    rates = np.atleast_2d(np.asarray(rates, float))
    R = len(geom.sys_idx)
    if rates.shape[1] != R:
        raise ValueError(f"window_rollup: rates must be (W, {R}) for this "
                         f"geometry, got {rates.shape}")
    if (rates < 0.0).any() or not np.isfinite(rates).all():
        raise ValueError("window_rollup: rates must be finite and >= 0")
    if table is None:
        table = columns.price(geom.plan)
    rel_j = reload_energy_j(geom, table)
    W = rates.shape[0]
    S = geom.n_systems
    # flatten windows to W*S virtual systems: row order within each window
    # matches the single-window case, so each bincount bin accumulates in
    # the identical order (bit-identical sums).
    sys_flat = (np.arange(W)[:, None] * S + geom.sys_idx[None, :]).ravel()
    tile = lambda col: np.tile(col, W)                      # noqa: E731
    c = _rollup(sys_flat, rates.ravel(),
                tile(geom.is_union[geom.sys_idx]), W * S,
                tile(table.mem_pj * 1e-12), tile(table.compute_pj * 1e-12),
                tile(table.latency_s), tile(table.standby_w),
                tile(table.wake_energy_j), tile(rel_j))
    per_sys = {k: c[k].reshape(W, S)
               for k in ("duty", "feasible", "standby_w", "wake_j",
                         "wake_rate", "dyn_w", "compute_w", "reload_w",
                         "p_mem_w")}
    return WindowColumns(
        geometry=geom, energy=table, rates=rates, reload_j=rel_j,
        stream_duty=c["stream_duty"].reshape(W, R),
        stream_dyn_w=c["stream_dyn_w"].reshape(W, R),
        switch_rate=c["switch_rate"].reshape(W, R), **per_sys)
