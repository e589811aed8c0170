"""Population-based joint-space optimizer: one columnar pass per generation.

A batched evolutionary / multi-start-hillclimb fleet over the DSE move
graph (``repro_torch.search.moves``): mutation draws 1-move neighbors (axis
moves, arch moves, ``Placement.with_level``), selection is crowded Pareto
rank (NSGA-II style), and the ENTIRE generation — every parent's sampled
children plus the full neighborhood of the incumbent best — is priced as
ONE ``EnergyTable`` pass (plus one ``AreaTable`` pass when area is an
objective), replacing ``hillclimb --dse``'s one-neighborhood-at-a-time
loop. Embedding the incumbent's full neighborhood makes the fleet an
elitist superset of the greedy walker: after g generations the best point
is at least as good as greedy's after g steps, which is the acceptance
bar the regression test pins.

Every evaluated point folds into a ``ParetoArchive`` (ids are the points
themselves), so a run's output is a frontier, not just an incumbent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.search.moves import DSE_AXES, neighbors
from repro_torch.search.pareto import ParetoArchive, pareto_mask


def objective_matrix(ev, points, objectives: Sequence[str],
                     ips: float = 10.0) -> np.ndarray:
    """(P, k) objective columns for ``points`` — one ``evaluate_table``
    pass, plus one ``area_table`` pass iff 'area' is requested."""
    points = list(points)
    table = ev.evaluate_table(points)
    areas = ev.area_table(points) if "area" in objectives else None
    cols = []
    for name in objectives:
        if name == "area":
            cols.append(areas.total_mm2)
        else:
            cols.append(table.column(name if name != "energy"
                                     else "total_pj", ips=ips))
    return np.stack([np.asarray(c, float) for c in cols], axis=1)


def pareto_ranks(values: np.ndarray) -> np.ndarray:
    """Non-dominated sorting: rank 0 = the frontier, rank 1 = the frontier
    after removing rank 0, ... (ties share the rank they first survive)."""
    v = np.asarray(values, float)
    ranks = np.full(len(v), -1, int)
    alive = np.arange(len(v))
    r = 0
    while len(alive):
        front = pareto_mask(v[alive])
        ranks[alive[front]] = r
        alive = alive[~front]
        r += 1
    return ranks


def crowding_distance(values: np.ndarray) -> np.ndarray:
    """NSGA-II crowding distance within one front (larger = lonelier;
    boundary points are infinite so extremes always survive selection)."""
    v = np.asarray(values, float)
    n, k = v.shape
    if n <= 2:
        return np.full(n, np.inf)
    dist = np.zeros(n)
    for j in range(k):
        order = np.argsort(v[:, j], kind="stable")
        span = v[order[-1], j] - v[order[0], j]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0:
            gaps = (v[order[2:], j] - v[order[:-2], j]) / span
            dist[order[1:-1]] += gaps
    return dist


def crowded_select(values: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` rows NSGA-II keeps: ascending Pareto rank,
    crowding distance (descending) breaking ties within the cut front."""
    v = np.asarray(values, float)
    if len(v) <= k:
        return np.arange(len(v))
    ranks = pareto_ranks(v)
    crowd = np.empty(len(v))
    for r in np.unique(ranks):
        sel = ranks == r
        crowd[sel] = crowding_distance(v[sel])
    # -crowd so larger distance sorts first inside a rank; stable keeps
    # stream order among exact ties (deterministic runs)
    order = np.lexsort((-crowd, ranks))
    return np.sort(order[:k])


@dataclass
class EvolveResult:
    """Outcome of one ``evolve`` run."""
    best_point: object
    best_value: float
    objectives: Tuple[str, ...]
    generations: int
    n_evaluated: int
    archive: ParetoArchive
    history: List[Dict] = field(default_factory=list)

    def frontier(self):
        """(points, values) of the evaluated-set Pareto frontier, sorted
        by the first objective."""
        return self.archive.frontier()


def default_seeds(workload: str) -> List:
    """Multi-start seed population: the greedy walker's CPU start plus the
    paper's corner designs across arch x {best nodes} x variants."""
    from repro_torch.core.space import DesignPoint
    seeds = [DesignPoint(workload=workload, arch="cpu", node=45,
                         variant="sram")]
    for arch in ("eyeriss", "simba"):
        for node in (45, 7):
            for variant in ("sram", "p1"):
                seeds.append(DesignPoint(workload=workload, arch=arch,
                                         node=node, variant=variant))
    return seeds


def evolve(ev, workload: str = "detnet",
           objectives: Sequence[str] = ("pmem",), ips: float = 10.0,
           generations: int = 10, population: int = 24, offspring: int = 3,
           seed: int = 0, seeds: Optional[Sequence] = None,
           axes: Optional[Dict] = None, techs: Optional[Sequence[str]] = None,
           on_generation=None) -> EvolveResult:
    """Run the fleet for ``generations`` steps and return the frontier.

    Per generation: candidates = current population + the full 1-move
    neighborhood of the incumbent best + ``offspring`` sampled neighbors
    per parent; everything not yet priced goes through ONE columnar pass;
    NSGA-II keeps ``population`` survivors. ``seed`` fixes the mutation
    draw (runs are deterministic). ``on_generation(gen, result_so_far)``
    observes progress.
    """
    objectives = tuple(objectives)
    if not objectives:
        raise ValueError("evolve: need >= 1 objectives")
    axes = dict(DSE_AXES if axes is None else axes)
    rng = np.random.default_rng(seed)
    pop = list(seeds) if seeds is not None else default_seeds(workload)
    evaluated: Dict = {}                 # point -> (k,) objective row
    archive = ParetoArchive(len(objectives))
    best_p, best_v = None, np.inf
    history: List[Dict] = []

    def price(cands):
        nonlocal best_p, best_v
        fresh = [c for c in cands if c not in evaluated]
        if fresh:
            vals = objective_matrix(ev, fresh, objectives, ips=ips)
            for c, row in zip(fresh, vals):
                evaluated[c] = row
            ids = np.empty(len(fresh), object)
            ids[:] = fresh
            archive.update(vals, ids=ids)
            j = int(np.argmin(vals[:, 0]))
            if vals[j, 0] < best_v:
                best_p, best_v = fresh[j], float(vals[j, 0])
        return len(fresh)

    price(pop)
    gen = 0
    for gen in range(1, generations + 1):
        cand = dict.fromkeys(pop)
        for nb in neighbors(best_p, axes, techs):
            cand.setdefault(nb)
        for parent in pop:
            nbs = neighbors(parent, axes, techs)
            take = min(offspring, len(nbs))
            for j in rng.choice(len(nbs), size=take, replace=False):
                cand.setdefault(nbs[j])
        cand = list(cand)
        n_new = price(cand)
        vals = np.stack([evaluated[c] for c in cand])
        keep = crowded_select(vals, population)
        pop = [cand[i] for i in keep]
        history.append(dict(generation=gen, candidates=len(cand),
                            priced=n_new, best=best_v,
                            frontier=len(archive)))
        if on_generation is not None:
            on_generation(gen, history[-1])
    return EvolveResult(best_point=best_p, best_value=best_v,
                        objectives=objectives, generations=gen,
                        n_evaluated=len(evaluated), archive=archive,
                        history=history)
