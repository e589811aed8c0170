"""Streaming multi-objective Pareto frontier in constant memory.

``ResultSet.pareto`` is the one-shot oracle: point i is dominated iff some
j is <= in every metric AND < in at least one (ties and duplicates all
survive). Dominance is transitive and ties never dominate, so folding a
stream of candidate blocks into an archive of current non-dominated rows —
pruning both directions at each fold — ends at EXACTLY the one-shot
frontier of everything streamed, independent of arrival order. That is
what lets a 10^7-point lattice stream through a fixed-size working set.

``ParetoArchive.update`` is the fold. Cost per block is dominated by the
archive prefilter (a handful of (block x archive-slice) broadcasts with
survivor shrinking — real frontiers kill >99% of candidates within the
first few archive rows); only prefilter survivors pay the exact
block-internal filter.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _pareto_mask_2d(v: np.ndarray) -> np.ndarray:
    """Exact 2-objective frontier mask by sweep line, O(n log n): sort by
    (obj0, obj1); a row is dominated iff a strictly-smaller-obj0 row has
    obj1 <= its own, or an equal-obj0 row has obj1 strictly smaller. Same
    tie/NaN semantics as the pairwise test (NaN rows neither dominate nor
    are dominated)."""
    keep = np.ones(len(v), bool)
    fin = np.flatnonzero(~np.isnan(v).any(axis=1))
    if not len(fin):
        return keep
    w = v[fin]
    order = np.lexsort((w[:, 1], w[:, 0]))
    a = w[order]
    first = np.empty(len(a), bool)
    first[0] = True
    first[1:] = a[1:, 0] != a[:-1, 0]
    gid = np.cumsum(first) - 1
    gmin = a[first, 1]                      # min obj1 within each obj0 group
    pmin = np.concatenate(                  # min obj1 over smaller obj0
        ([np.inf], np.minimum.accumulate(gmin)[:-1]))
    dom = (a[:, 1] >= pmin[gid]) | (a[:, 1] > gmin[gid])
    keep[fin[order]] = ~dom
    return keep


def pareto_mask(values: np.ndarray, chunk: int = 256) -> np.ndarray:
    """Non-dominated mask over rows of ``values`` (all metrics minimized),
    same dominance semantics as ``ResultSet.pareto`` (ties survive).
    Memory stays O(n * chunk * k); the 2-objective case takes an exact
    O(n log n) sweep instead of the pairwise test."""
    v = np.asarray(values, float)
    if v.ndim != 2:
        raise ValueError(f"pareto_mask: want (n, k) values, got {v.shape}")
    if v.shape[1] == 2 and len(v) > 64:
        return _pareto_mask_2d(v)
    dominated = np.zeros(len(v), bool)
    for c0 in range(0, len(v), chunk):
        vc = v[c0:c0 + chunk]
        le = (v[:, None, :] <= vc[None, :, :]).all(axis=2)
        lt = (v[:, None, :] < vc[None, :, :]).any(axis=2)
        dominated[c0:c0 + chunk] = (le & lt).any(axis=0)
    return ~dominated


def dominated_by(values: np.ndarray, ref: np.ndarray,
                 block: int = 64) -> np.ndarray:
    """Per-row mask: is values[i] dominated by ANY row of ``ref``?

    Iterates ``ref`` in small blocks and drops already-dominated rows
    between blocks — on frontier-shaped data the survivor set collapses
    after the first block, so the cost is ~one (n x block x k) broadcast
    rather than (n x len(ref) x k).
    """
    v = np.asarray(values, float)
    r = np.asarray(ref, float)
    out = np.zeros(len(v), bool)
    if not len(r) or not len(v):
        return out
    if v.shape[1] == 2 and len(r) <= 256:
        # 2-objective fast path: one vector expression per ref row over
        # column views beats the 3-D broadcast (no (n x block x k) temp);
        # past a few hundred ref rows the per-row call overhead wins out
        # and the blocked broadcast below takes over
        v0, v1 = v[:, 0], v[:, 1]
        dom = out
        for a, b in r:
            dom |= ((a <= v0) & (b <= v1)) & ((a < v0) | (b < v1))
            if dom.all():
                break
        return dom
    alive = np.arange(len(v))
    for r0 in range(0, len(r), block):
        rb = r[r0:r0 + block]
        va = v[alive]
        le = (rb[None, :, :] <= va[:, None, :]).all(axis=2)
        lt = (rb[None, :, :] < va[:, None, :]).any(axis=2)
        dom = (le & lt).any(axis=1)
        out[alive[dom]] = True
        alive = alive[~dom]
        if not len(alive):
            break
    return out


class ParetoArchive:
    """Incremental non-dominated archive over a stream of objective rows.

    ``update(values, ids)`` folds a block of candidates in; ``ids`` carries
    whatever identifies each row upstream (global lattice indices from the
    streaming pricer, ``DesignPoint``s from the optimizer — the archive
    never looks inside them). After any sequence of updates the archive
    holds exactly the one-shot Pareto frontier of every feasible row ever
    streamed (ties included), which the parity tests check against
    ``ResultSet.pareto``.
    """

    def __init__(self, n_objectives: int, block: int = 2048):
        if n_objectives < 1:
            raise ValueError("ParetoArchive: need >= 1 objectives")
        self.k = int(n_objectives)
        self._block = int(block)
        self._values = np.empty((0, self.k), float)
        self._ids = np.empty(0, object)
        self.seen = 0          # total rows streamed (incl. infeasible)
        self.dropped = 0       # rows dropped by the feasibility mask

    # --- views --------------------------------------------------------------
    @property
    def values(self) -> np.ndarray:
        """(F, k) objective rows of the current frontier (copy)."""
        return self._values.copy()

    @property
    def ids(self) -> np.ndarray:
        """(F,) ids of the current frontier, aligned with ``values``."""
        return self._ids.copy()

    def __len__(self) -> int:
        return len(self._values)

    def frontier(self):
        """(ids, values) sorted by the first objective (stable output for
        reports; the archive itself is unordered)."""
        order = np.argsort(self._values[:, 0], kind="stable")
        return self._ids[order], self._values[order]

    # --- fold ---------------------------------------------------------------
    def update(self, values, ids=None,
               feasible: Optional[np.ndarray] = None) -> int:
        """Fold a candidate block into the archive; returns the number of
        rows admitted (archive rows they displace are pruned). ``feasible``
        rows marked False are counted in ``dropped`` and never archived."""
        v = np.asarray(values, float)
        if v.ndim == 1:
            v = v.reshape(-1, self.k) if self.k > 1 else v.reshape(-1, 1)
        if v.shape[1] != self.k:
            raise ValueError(
                f"update: want (n, {self.k}) values, got {v.shape}")
        n = len(v)
        if ids is None:
            ids_arr = np.arange(self.seen, self.seen + n)
        elif isinstance(ids, np.ndarray) and ids.ndim == 1:
            ids_arr = ids          # kept non-object until insertion (cheap)
        else:
            ids_arr = np.empty(n, object)
            ids_arr[:] = list(ids)
        if len(ids_arr) != n:
            raise ValueError(f"update: {len(ids_arr)} ids for {n} rows")
        self.seen += n
        if feasible is not None:
            feasible = np.asarray(feasible, bool)
            self.dropped += int((~feasible).sum())
            v, ids_arr = v[feasible], ids_arr[feasible]
            n = len(v)
        if not n:
            return 0
        # one whole-block prefilter against the current archive: on a warm
        # stream the frontier kills >99.9% of a chunk right here, so the
        # passes below only ever see a handful of survivors
        alive = ~dominated_by(v, self._values)
        v, ids_arr = v[alive], ids_arr[alive]
        n = len(v)
        if not n:
            return 0
        if self.k == 2 and n > 64:
            # exact local frontier (O(n log n) sweep): the block fold below
            # then only ever sees the survivors' own frontier
            keep = _pareto_mask_2d(v)
            v, ids_arr = v[keep], ids_arr[keep]
            n = len(v)
        if n > self._block:
            # strongest candidates first: the archive fills with killers
            # early and later blocks die in the prefilter (pure heuristic —
            # the final frontier is order-independent)
            lo = np.nanmin(v, axis=0)
            span = np.nanmax(v, axis=0) - lo
            span[span == 0] = 1.0
            order = np.argsort(((v - lo) / span).sum(axis=1), kind="stable")
            v, ids_arr = v[order], ids_arr[order]
        admitted = 0
        for b0 in range(0, n, self._block):
            bv, bi = v[b0:b0 + self._block], ids_arr[b0:b0 + self._block]
            alive = ~dominated_by(bv, self._values)
            bv, bi = bv[alive], bi[alive]
            if not len(bv):
                continue
            keep = pareto_mask(bv)
            bv, bi = bv[keep], bi[keep]
            if not len(bv):
                continue
            old = ~dominated_by(self._values, bv)
            self._values = np.concatenate([self._values[old], bv])
            self._ids = np.concatenate([self._ids[old], bi])
            admitted += len(bv)
        return admitted
