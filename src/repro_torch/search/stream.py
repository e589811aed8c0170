"""Chunked columnar pricing: whole joint lattices at numpy gather speed.

``evaluate_stream(ev, space)`` prices a design space chunk by chunk, each
chunk as ONE ``EnergyTable`` (and optionally ``AreaTable``) pass, so peak
memory is O(chunk) while the space may be 10^6-10^8 points. Two paths:

  * generic — any point iterable: buffer ``chunk_size`` points, assemble a
    plan through ``Evaluator.assemble_plan`` (structural caches shared
    across chunks; the plan LRU is deliberately bypassed — one-shot chunks
    must not evict the sweeps' resident plans).
  * compiled (``LatticePricer``) — a pure-product ``LazySpace``: every
    per-point plan column is a function of a handful of axis positions, so
    the pricer FACTORS the lattice once (traffic groups over workload/
    precision/arch axes, technology rows over placement x level-set x
    default-device, node constants over node axes) and each chunk is
    assembled by ``unravel``-style index arithmetic + numpy gathers — no
    ``DesignPoint`` is ever constructed in the hot path. Frontier
    survivors are materialized lazily through ``LazySpace.point_at``.

Both paths run the SAME pricing kernels (``columns.price``/``area``) on
the same float64 geometry, elementwise per point — chunked output is
byte-identical to the one-shot ``evaluate_table``, which the parity suite
checks across chunk sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import columns
from repro_torch.core import devices as dev
from repro_torch.core.space import Bind, product_kwargs
from repro_torch.search.lazy import LazySpace
from repro_torch.search.pareto import ParetoArchive

DEFAULT_CHUNK = 65536

# DesignPoint fields by which plan column they drive: GROUP fields select
# the mapped traffic group (sizing + mapping), NODE fields the node-indexed
# constants and the paper-default device, PLACE fields the per-level
# technology row. An axis whose fields span categories joins each of them.
GROUP_FIELDS = frozenset({"workload", "extract_kw", "suite", "arch",
                          "pe_config", "weight_bits", "act_bits",
                          "psum_bits"})
NODE_FIELDS = frozenset({"node"})
PLACE_FIELDS = frozenset({"placement", "variant", "nvm"})

_DEFAULT_NVM = {"energy": "stt", "area": "vgsot"}   # Evaluator.plan parity


@dataclass(frozen=True)
class StreamChunk:
    """One priced slice of a streamed space: global offset + tables."""
    offset: int
    points: Sequence                  # lazy or eager point views
    energy: columns.EnergyTable
    area: Optional[columns.AreaTable] = None

    def __len__(self) -> int:
        return len(self.energy)


class _LazyPoints(Sequence):
    """Sequence view over a slice of an indexable LazySpace: points are
    built on access only (plan/table ``points`` stay O(1) memory)."""
    __slots__ = ("_space", "_start", "_stop")

    def __init__(self, space: LazySpace, start: int, stop: int):
        self._space, self._start, self._stop = space, start, stop

    def __len__(self) -> int:
        return self._stop - self._start

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self._space.point_at(self._start + i)


def evaluate_stream(ev, space, chunk_size: int = DEFAULT_CHUNK,
                    with_area: bool = False) -> Iterator[StreamChunk]:
    """Price ``space`` as a stream of ``StreamChunk``s (see module doc).

    ``space`` may be any DesignPoint iterable; a pure-product ``LazySpace``
    takes the compiled gather path. ``with_area`` additionally prices the
    area plan per chunk (same default-NVM resolution as ``area_table``).
    Passing an already-compiled ``LatticePricer`` streams it directly —
    compilation is paid once across repeated sweeps of the same lattice.
    """
    if chunk_size <= 0:
        raise ValueError(f"evaluate_stream: chunk_size {chunk_size} <= 0")
    if isinstance(space, LatticePricer):
        if with_area and not space.with_area:
            raise ValueError("evaluate_stream: pricer was compiled without "
                             "with_area")
        yield from space.stream(chunk_size)
        return
    if isinstance(space, LazySpace) and space.is_product:
        yield from LatticePricer(ev, space,
                                 with_area=with_area).stream(chunk_size)
        return
    buf, off = [], 0
    for p in space:
        buf.append(p)
        if len(buf) >= chunk_size:
            yield _price_points(ev, buf, off, with_area)
            off += len(buf)
            buf = []
    if buf:
        yield _price_points(ev, buf, off, with_area)


def _price_points(ev, pts, offset: int, with_area: bool) -> StreamChunk:
    """Generic chunk pricing via the evaluator's shared plan assembly
    (bypasses the plan LRU: streamed chunks are one-shot by construction)."""
    pts = tuple(pts)
    pairs = [(p, ev.base_arch(p)) for p in pts]
    energy = columns.price(
        ev.assemble_plan(pairs, default=_DEFAULT_NVM["energy"]))
    at = None
    if with_area:
        at = columns.area(
            ev.assemble_plan(pairs, default=_DEFAULT_NVM["area"]))
    return StreamChunk(offset, pts, energy, at)


class LatticePricer:
    """Compiled chunk assembler for a pure-product ``LazySpace``.

    Compilation enumerates only the SUB-lattices that matter: the group
    axes' cross product (one ``Evaluator.traffic`` table per distinct
    mapping group), the node axes' (paper-default device + clock/scale
    keys) and the placement axes' (``Placement.techs_for`` rows per
    (placement, level-set, default-device)). A chunk is then priced by
    index arithmetic over the row-major global index plus (P,)-shaped
    gathers from those tables.
    """

    def __init__(self, ev, space: LazySpace, with_area: bool = False):
        if not (isinstance(space, LazySpace) and space.is_product):
            raise TypeError("LatticePricer: need a pure-product LazySpace "
                            "(no where/map ops)")
        if len(space) == 0:
            raise ValueError("LatticePricer: empty space")
        self.ev, self.space, self.with_area = ev, space, with_area
        self._norm = space.axes
        self._values: Tuple[Tuple, ...] = tuple(space.axes.values())
        self.shape = space.shape
        strides = []
        m = 1
        for s in reversed(self.shape):
            strides.append(m)
            m *= s
        self._strides = tuple(reversed(strides))

        fsets = []
        for name, vals in self._norm.items():
            fs = set()
            for v in vals:
                fs |= set(v.fields) if isinstance(v, Bind) else {name}
            fsets.append(frozenset(fs))
        self._gax = tuple(i for i, f in enumerate(fsets) if f & GROUP_FIELDS)
        self._nax = tuple(i for i, f in enumerate(fsets) if f & NODE_FIELDS)
        self._pax = tuple(i for i, f in enumerate(fsets) if f & PLACE_FIELDS)
        self._compile()

    # --- compilation --------------------------------------------------------
    def _point(self, posmap):
        """Representative DesignPoint with the listed axes at the given
        positions and every other axis at its first value."""
        combo = tuple(self._values[i][posmap.get(i, 0)]
                      for i in range(len(self._values)))
        from repro_torch.core.space import DesignPoint
        return DesignPoint(**product_kwargs(self._norm, combo))

    def _subshape(self, axlist) -> Tuple[int, ...]:
        return tuple(self.shape[i] for i in axlist) or (1,)

    def _enumerate(self, axlist):
        import itertools
        for flat, pos in enumerate(
                itertools.product(*map(range, self._subshape(axlist)))):
            yield flat, dict(zip(axlist, pos))

    def _compile(self):
        ev = self.ev
        # group tables: one mapped TrafficTable per distinct (workload_key,
        # sized arch); g-combos alias into them via _g_of
        n_g = int(np.prod(self._subshape(self._gax)))
        groups, gkey_pos = [], {}
        self._g_of = np.empty(n_g, np.int64)
        self._wname = np.empty(n_g, object)
        for flat, posmap in self._enumerate(self._gax):
            p = self._point(posmap)
            base = ev.base_arch(p)
            key = (p.workload_key(), base)
            gid = gkey_pos.get(key)
            if gid is None:
                gid = gkey_pos[key] = len(groups)
                groups.append(ev.traffic(p, base))
            self._g_of[flat] = gid
            self._wname[flat] = p.workload_name
        self._groups = tuple(groups)
        self._g = columns.group_geometry(groups)
        self._g_wcls = self._g["cls"] == "weight"
        # the six pure-float (G, L) tables as one (G, 6, L) block: chunk
        # assembly pays ONE big gather and hands out views
        g = self._g
        self._gstack = np.stack([g["macro"], g["cap"], g["bus"], g["count"],
                                 g["read"], g["write"]], axis=1)
        # chunk assembly hands out views of this block inside PricingPlans;
        # read-only here makes every such view read-only too (MU guarantee)
        self._gstack.setflags(write=False)
        self._g_arch = np.array([t.arch.name for t in groups], object)
        lsets, lpos = [], {}
        self._lsid_of_g = np.empty(len(groups), np.int64)
        for gid, t in enumerate(groups):
            ls = lpos.get(t.arch.levels)
            if ls is None:
                ls = lpos[t.arch.levels] = len(lsets)
                lsets.append(t.arch.levels)
            self._lsid_of_g[gid] = ls

        # node tables: node value, node_list position, per-kind default NVM
        n_n = int(np.prod(self._subshape(self._nax)))
        self._node_of = np.empty(n_n, np.int64)
        for flat, posmap in self._enumerate(self._nax):
            self._node_of[flat] = self._point(posmap).node
        self._node_list = tuple(dict.fromkeys(int(n) for n in self._node_of))
        npos = {n: i for i, n in enumerate(self._node_list)}
        self._nodeidx_of = np.array(
            [npos[int(n)] for n in self._node_of], np.int64)
        self._didx_of, self._defaults = {}, {}
        for kind, d in _DEFAULT_NVM.items():
            devs = [dev.PAPER_NVM_AT_NODE.get(int(n), d)
                    for n in self._node_of]
            dlist = tuple(dict.fromkeys(devs))
            self._defaults[kind] = dlist
            self._didx_of[kind] = np.array(
                [dlist.index(x) for x in devs], np.int64)

        # clock keys per (group, node-combo)
        ckeys, ckey_pos = [], {}
        self._clk = np.empty((len(groups), n_n), np.int64)
        for gid, t in enumerate(groups):
            for nf in range(n_n):
                k = (int(self._node_of[nf]), t.arch.clock_class)
                i = ckey_pos.get(k)
                if i is None:
                    i = ckey_pos[k] = len(ckeys)
                    ckeys.append(k)
                self._clk[gid, nf] = i
        self._clock_keys = tuple(ckeys)

        # placement tables: variant labels, bound NVMs, technology rows per
        # (placement, level-set, default-device), deduplicated
        n_p = int(np.prod(self._subshape(self._pax)))
        placements = []
        self._variant = np.empty(n_p, object)
        pl_nvm = np.empty(n_p, object)
        for flat, posmap in self._enumerate(self._pax):
            p = self._point(posmap)
            placements.append(p.placement)
            self._variant[flat] = p.variant
            pl_nvm[flat] = p.nvm
        self._nvm_tab, self._rows = {}, {}
        Lmax = self._g["Lmax"]
        for kind, d in _DEFAULT_NVM.items():
            tab = np.empty((n_p, n_n), object)
            for pf in range(n_p):
                for nf in range(n_n):
                    tab[pf, nf] = pl_nvm[pf] or dev.PAPER_NVM_AT_NODE.get(
                        int(self._node_of[nf]), d)
            self._nvm_tab[kind] = tab
            dlist = self._defaults[kind]
            rnames, rpos = [], {}
            trow = np.empty((n_p, len(lsets), len(dlist)), np.int64)
            for pf, pl in enumerate(placements):
                for ls, levels in enumerate(lsets):
                    for df, dd in enumerate(dlist):
                        row = tuple(pl.techs_for(levels, default_nvm=dd))
                        row += ("sram",) * (Lmax - len(row))
                        rid = rpos.get(row)
                        if rid is None:
                            rid = rpos[row] = len(rnames)
                            rnames.append(row)
                        trow[pf, ls, df] = rid
            tech_list = tuple(sorted({t for row in rnames for t in row}))
            tpos = {t: i for i, t in enumerate(tech_list)}
            rows_names = np.empty((len(rnames), Lmax), object)
            rows_idx = np.empty((len(rnames), Lmax), np.int64)
            for r, row in enumerate(rnames):
                rows_names[r, :] = row
                rows_idx[r, :] = [tpos[t] for t in row]
            self._rows[kind] = (trow, rows_names, rows_idx, tech_list)

    # --- chunk assembly -----------------------------------------------------
    def _subflat(self, idx: np.ndarray, axlist) -> np.ndarray:
        """Row-major flat index over the sub-shape of ``axlist`` for each
        global index (pure integer arithmetic, no unraveling to tuples)."""
        if not axlist:
            return np.zeros(len(idx), np.int64)
        out = np.zeros(len(idx), np.int64)
        m = 1
        for a in reversed(axlist):
            out += ((idx // self._strides[a]) % self.shape[a]) * m
            m *= self.shape[a]
        return out

    def _plan(self, pts, gf, gid, nf, pf, kind: str) -> columns.PricingPlan:
        g = self._g
        trow, rows_names, rows_idx, tech_list = self._rows[kind]
        rid = trow[pf, self._lsid_of_g[gid], self._didx_of[kind][nf]]
        blk = self._gstack[gid]                      # (P, 6, L) one gather
        return columns.PricingPlan(
            points=pts, groups=self._groups, gidx=gid,
            workloads=self._wname[gf], arch_names=self._g_arch[gid],
            variants=self._variant[pf], nvms=self._nvm_tab[kind][pf, nf],
            nodes=self._node_of[nf], node_list=self._node_list,
            node_idx=self._nodeidx_of[nf], clock_keys=self._clock_keys,
            clock_idx=self._clk[gid, nf], is_cpu=g["is_cpu"][gid],
            num_pes=g["pes"][gid], macs=g["macs"][gid],
            delivery_macs=g["dmacs"][gid],
            compute_cycles=g["cycles"][gid],
            mul_frac=g["mul_frac"][gid], issue_ratio=g["issue_ratio"][gid],
            dlvw_frac=g["dlvw_frac"][gid], mask=g["mask"][gid],
            level_names=g["names"][gid], level_cls=g["cls"][gid],
            weight_cls=self._g_wcls[gid], macro_kb=blk[:, 0],
            capacity_kb=blk[:, 1], bus_bits=blk[:, 2],
            count=blk[:, 3], read_bits=blk[:, 4],
            write_bits=blk[:, 5], tech_names=rows_names[rid],
            tech_list=tech_list, tech_idx=rows_idx[rid])

    def chunk(self, start: int, stop: int) -> StreamChunk:
        """Price global indices [start, stop) as one columnar pass."""
        idx = np.arange(start, stop, dtype=np.int64)
        gf = self._subflat(idx, self._gax)
        nf = self._subflat(idx, self._nax)
        pf = self._subflat(idx, self._pax)
        gid = self._g_of[gf]
        pts = _LazyPoints(self.space, int(start), int(stop))
        energy = columns.price(self._plan(pts, gf, gid, nf, pf, "energy"))
        at = None
        if self.with_area:
            at = columns.area(self._plan(pts, gf, gid, nf, pf, "area"))
        return StreamChunk(int(start), pts, energy, at)

    def stream(self, chunk_size: int = DEFAULT_CHUNK
               ) -> Iterator[StreamChunk]:
        n = len(self.space)
        for start in range(0, n, chunk_size):
            yield self.chunk(start, min(start + chunk_size, n))


# --- objective columns + streaming frontier --------------------------------

OBJECTIVES = ("energy", "latency", "edp", "pmem", "area")


def chunk_objectives(ch: StreamChunk, objectives: Sequence[str],
                     ips: float = 10.0) -> np.ndarray:
    """(P, k) objective matrix for one chunk, all columns minimized.
    ``area`` requires the chunk to have been priced ``with_area``.

    The energy/edp/pmem columns all reduce the same (P, L) access-energy
    arrays, so the shared intermediates (``mem_pj``, ``total_pj``) are
    computed at most once per chunk — same expressions and operation order
    as the ``EnergyTable`` properties, hence bitwise-identical columns."""
    et = ch.energy
    need = set(objectives)
    mem_pj = et.mem_pj if need & {"energy", "edp", "pmem"} else None
    total_pj = (et.compute_pj + mem_pj) if need & {"energy", "edp"} else None
    cols = []
    for name in objectives:
        if name == "energy":
            cols.append(total_pj)
        elif name == "latency":
            cols.append(et.latency_s)
        elif name == "edp":
            cols.append(total_pj * 1e-12 * et.latency_s)
        elif name == "pmem":
            cols.append(columns._pmem(mem_pj * 1e-12, et.latency_s,
                                      et.standby_w, et.wake_energy_j,
                                      np.asarray(ips, float)))
        elif name == "area":
            if ch.area is None:
                raise ValueError("objective 'area': stream with "
                                 "with_area=True")
            cols.append(ch.area.total_mm2)
        else:
            raise ValueError(
                f"unknown objective {name!r} (choose from {OBJECTIVES})")
    return np.stack(cols, axis=1)


def stream_frontier(ev, space, objectives: Sequence[str] = ("edp", "pmem"),
                    ips: float = 10.0, chunk_size: int = DEFAULT_CHUNK,
                    min_ips: Optional[float] = None,
                    archive: Optional[ParetoArchive] = None,
                    progress=None) -> ParetoArchive:
    """Stream ``space`` through the chunked pricer and fold every chunk
    into a ``ParetoArchive`` (ids = global row-major indices; materialize
    survivors with ``space.point_at``). ``min_ips`` adds the feasibility
    gate: designs too slow to sustain it are dropped, not archived.
    Existing ``archive``s accumulate across calls (multi-lattice unions);
    ``space`` may be a pre-compiled ``LatticePricer`` for repeated sweeps.
    ``progress(chunk, archive)`` observes each fold."""
    objectives = tuple(objectives)
    if archive is None:
        archive = ParetoArchive(len(objectives))
    elif archive.k != len(objectives):
        raise ValueError(f"archive has {archive.k} objectives, "
                         f"want {len(objectives)}")
    base = archive.seen
    for ch in evaluate_stream(ev, space, chunk_size=chunk_size,
                              with_area="area" in objectives):
        vals = chunk_objectives(ch, objectives, ips)
        feasible = (ch.energy.max_ips >= min_ips) if min_ips is not None \
            else None
        ids = np.arange(base + ch.offset, base + ch.offset + len(ch))
        archive.update(vals, ids=ids, feasible=feasible)
        if progress is not None:
            progress(ch, archive)
    return archive
