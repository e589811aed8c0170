"""Streaming joint-space Pareto search, the port of ``tools/search.py``.

Lattice mode (--lattice): stream the full joint design lattice
{workload x precision x pe_config x node x placement} for one architecture
through the chunked columnar pricer into a constant-memory Pareto frontier
(``repro_torch.search.stream``); peak memory O(chunk).

  PYTHONPATH=src python -m repro_torch.launch.search --lattice \
      --arch simba [--workload detnet --workload edsnet] \
      [--objectives edp,pmem] [--chunk 65536] [--min-ips 10] \
      [--out frontier.json]

Evolve mode (--evolve): population-based multi-objective search
(``repro_torch.search.evolve``): NSGA-II crowded selection over mutation
neighborhoods, one columnar pricing pass per generation.

  PYTHONPATH=src python -m repro_torch.launch.search --evolve \
      --workload detnet [--objectives pmem] [--budget 10] \
      [--population 24] [--out f.json]

Everything runs in numpy on the host; the objectives are the model's
estimates for the XR accelerators it prices, not measurements of the
machine this runs on. The frontier JSON is the tool's, byte for byte.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from repro_torch.core.experiment import PLACEMENT_TECHS, Evaluator
from repro_torch.core.placement import Placement
from repro_torch.core.space import DesignSpace
from repro_torch.search.evolve import evolve
from repro_torch.search.stream import LatticePricer, stream_frontier

# the paper's precision sub-lattice: None = config default per field
PRECISION_AXES = dict(
    weight_bits=(None, 8, 6, 4, 2),
    act_bits=(None, 8, 6, 4, 2),
    psum_bits=(None, 16, 20, 24, 28, 32, 40, 48),
)


def point_row(p, vals, objectives, pid=None):
    """JSON-friendly frontier row for one design point."""
    row = {
        "workload": p.workload_name, "arch": p.arch, "node": p.node,
        "pe_config": p.pe_config, "variant": p.variant,
        "nvm": p.nvm, "precision": p.precision_label,
        "objectives": {k: float(v) for k, v in zip(objectives, vals)},
    }
    if pid is not None:
        row["lattice_index"] = int(pid)
    return row


def build_lattice(a):
    placements = Placement.enumerate(a.arch, PLACEMENT_TECHS)
    if a.max_placements:
        placements = placements[:a.max_placements]
    return DesignSpace.product_iter(
        f"joint[{a.arch}]",
        workload=tuple(a.workload) or ("detnet",),
        arch=(a.arch,),
        pe_config=("v1", "v2"),
        **PRECISION_AXES,
        node=(45, 40, 28, 22, 7),
        placement=tuple(placements),
    )


def lattice_main(a):
    """Stream the lattice into a frontier; returns (lattice, archive,
    frontier rows)."""
    ev = Evaluator()
    objectives = tuple(a.objectives.split(","))
    space = build_lattice(a)
    n = len(space)
    print(f"=== lattice search: {space.name}, {n:,} points, "
          f"objectives {objectives} ===")
    t0 = time.monotonic()
    pricer = LatticePricer(ev, space, with_area="area" in objectives)
    t1 = time.monotonic()
    print(f"  compiled {len(pricer._groups)} traffic groups "
          f"in {t1 - t0:.2f}s")

    def progress(ch, arc):
        done = ch.offset + len(ch)
        if done == n or (ch.offset // a.chunk) % 8 == 7:
            print(f"  {done:,}/{n:,} streamed, frontier {len(arc)}")

    arc = stream_frontier(ev, pricer, objectives=objectives, ips=a.ips,
                          chunk_size=a.chunk, min_ips=a.min_ips,
                          progress=progress)
    dt = time.monotonic() - t1
    print(f"\nstreamed {n:,} designs in {dt:.2f}s "
          f"({n / dt / 1e6:.2f}M designs/sec), "
          f"frontier {len(arc)} of {arc.seen:,} "
          f"({arc.dropped:,} infeasible)")
    ids, vals = arc.frontier()
    rows = [point_row(space.point_at(int(i)), v, objectives, pid=int(i))
            for i, v in zip(ids, vals)]
    for r in rows[:10]:
        objs = "  ".join(f"{k}={v:.3e}" for k, v in r["objectives"].items())
        print(f"  {r['workload']}/{r['arch']}/{r['node']}nm/{r['variant']}"
              f"/{r['pe_config']}/{r['precision']}  {objs}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"objectives": list(objectives), "seen": arc.seen,
                       "dropped": arc.dropped, "frontier": rows}, f, indent=1)
        print(f"frontier written to {a.out}")
    return space, arc, rows


def evolve_main(a):
    """Run the population search; returns (EvolveResult, frontier rows)."""
    ev = Evaluator()
    objectives = tuple(a.objectives.split(","))
    print(f"=== evolve: {a.workload}, objectives {objectives}, "
          f"{a.budget} generations x {a.population} ===")
    t0 = time.monotonic()

    def on_generation(g, h):
        print(f"  gen {g}: {h['candidates']} candidates "
              f"({h['priced']} newly priced), frontier {h['frontier']}, "
              f"best {objectives[0]}={h['best']:.3e}")

    res = evolve(ev, workload=a.workload, objectives=objectives, ips=a.ips,
                 generations=a.budget, population=a.population,
                 seed=a.seed, on_generation=on_generation)
    dt = time.monotonic() - t0
    p = res.best_point
    print(f"\nbest after {res.generations} generations "
          f"({dt:.1f}s, {res.n_evaluated} designs priced):")
    print(f"  {p.arch} @ {p.node}nm, {p.variant}/{p.nvm or 'auto'}, "
          f"pe={p.pe_config}, {p.precision_label}: "
          f"{objectives[0]}={res.best_value:.3e}")
    pts, vals = res.frontier()
    rows = [point_row(q, v, objectives) for q, v in zip(pts, vals)]
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"objectives": list(objectives),
                       "generations": res.generations,
                       "evaluated": res.n_evaluated,
                       "frontier": rows}, f, indent=1)
        print(f"frontier written to {a.out}")
    return res, rows


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--lattice", action="store_true",
                      help="stream the full joint lattice to a frontier")
    mode.add_argument("--evolve", action="store_true",
                      help="population-based search (NSGA-II selection)")
    p.add_argument("--workload", action="append", default=[],
                   help="workload name (repeatable in lattice mode; "
                        "default detnet)")
    p.add_argument("--arch", default="simba",
                   help="[lattice] architecture whose placements span the "
                        "placement axis")
    p.add_argument("--objectives", default="edp,pmem",
                   help="comma list from {energy,latency,edp,pmem,area}")
    p.add_argument("--ips", type=float, default=10.0,
                   help="inference rate for the pmem objective")
    p.add_argument("--min-ips", type=float, default=None,
                   help="[lattice] feasibility gate: drop designs whose "
                        "max sustainable IPS is below this")
    p.add_argument("--chunk", type=int, default=65536,
                   help="[lattice] designs priced per columnar pass")
    p.add_argument("--max-placements", type=int, default=None,
                   help="[lattice] cap the placement axis")
    p.add_argument("--budget", type=int, default=10,
                   help="[evolve] generations")
    p.add_argument("--population", type=int, default=24,
                   help="[evolve] survivors per generation")
    p.add_argument("--seed", type=int, default=0, help="[evolve] RNG seed")
    p.add_argument("--out", help="write the frontier as JSON")
    a = p.parse_args(argv)
    if a.evolve:
        a.workload = a.workload[0] if a.workload else "detnet"
    return a


def main(argv: Optional[Sequence[str]] = None):
    a = parse_args(argv)
    return evolve_main(a) if a.evolve else lattice_main(a)


if __name__ == "__main__":
    main()
