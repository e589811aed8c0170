"""Trace-driven XR system simulation, the port of ``tools/trace.py``
(``repro_torch.trace``, DESIGN.md §11).

Simulate one scenario on one placement (both contention modes) and export
the timeline as Chrome tracing JSON for Perfetto / chrome://tracing:

  PYTHONPATH=src python -m repro_torch.launch.trace --scenario gaming \
      --placement p1 [--arch simba --node 7] [--battery-mah 500] \
      [--trace-out trace.json]

Sweep mode (--sweep): rank the full per-level technology lattice (4 techs
^ 4 Simba levels = 256 placements) by battery life under the scenario,
one batched columnar pass over all windows x placements:

  PYTHONPATH=src python -m repro_torch.launch.trace --sweep \
      --scenario gaming [--mode reload] [--top 10] [--out ranked.json]

``--placement`` accepts a variant label (sram/p0/p1/stt/sot/vgsot, via
``Placement.variant``) or a per-level spec like ``lvl=tech,lvl=tech``.
Everything runs in numpy on the host; powers and battery hours are the
model's estimates for the XR accelerator it prices, not measurements of
the machine this runs on. The rows and the Chrome trace are the tool's,
byte for byte.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from repro_torch.core import schedule
from repro_torch.core.experiment import (SWEEPS, XR_BUNDLE, Evaluator,
                                         default_evaluator)
from repro_torch.core.placement import Placement
from repro_torch.trace import get_scenario, simulate, write_chrome_trace


def parse_placement(spec):
    if "=" not in spec:
        try:
            return Placement.variant(spec)
        except ValueError:
            return Placement.uniform(spec)
    mapping = {}
    for part in spec.split(","):
        lvl, _, tech = part.partition("=")
        if not lvl or not tech:
            raise SystemExit(f"bad --placement entry {part!r} "
                             f"(want level=tech)")
        mapping[lvl.strip()] = tech.strip()
    return Placement.per_level(mapping)


def simulate_one(a) -> List[Dict]:
    ev = Evaluator(cache_reports=False)
    sc = get_scenario(a.scenario, duration_s=a.duration)
    pl = parse_placement(a.placement)
    pts = [schedule.SystemPoint(XR_BUNDLE, a.arch, a.node, placement=pl,
                                mode=m) for m in schedule.MODES]
    tab = simulate(ev, pts, sc, battery_mah=a.battery_mah)

    print(f"scenario {sc.name} ({sc.duration_s:g}s, {tab.n_windows} "
          f"windows)  {a.arch}@{a.node}nm  placement {pl.label}  "
          f"battery {tab.battery_mah:g} mAh")
    hdr = (f"{'mode':8s} {'avg mW':>9s} {'peak mW':>9s} {'p99 mW':>9s} "
           f"{'reload mJ':>10s} {'wake mJ':>9s} {'miss':>5s} "
           f"{'battery h':>10s}")
    print(hdr)
    rows = []
    for i, p in enumerate(tab.points):
        r = tab.report(i)
        print(f"{p.mode:8s} {r.avg_p_total_w * 1e3:9.3f} "
              f"{r.peak_p_total_w * 1e3:9.3f} {r.p99_p_total_w * 1e3:9.3f} "
              f"{r.reload_energy_j * 1e3:10.4f} "
              f"{r.wake_energy_j * 1e3:9.4f} {r.miss_windows:5d} "
              f"{r.battery_h:10.1f}")
        rows.append(dict(placement=pl.label, arch=a.arch, node=a.node,
                         **r.to_row()))
    if a.trace_out:
        write_chrome_trace(tab, a.trace_out)
        print(f"chrome trace written to {a.trace_out} "
              f"(open in ui.perfetto.dev)")
    return rows


def sweep(a) -> List[Dict]:
    rows = SWEEPS["trace"].rows(default_evaluator(), scenario=a.scenario,
                                arch=a.arch, node=a.node, mode=a.mode,
                                battery_mah=a.battery_mah)
    top = rows[:a.top] if a.top else rows
    print(f"scenario {a.scenario}  {a.arch}@{a.node}nm  mode {a.mode}  "
          f"{len(rows)} placements (top {len(top)} by battery life)")
    print(f"{'rank':>4s} {'placement':24s} {'avg mW':>9s} {'peak mW':>9s} "
          f"{'miss':>5s} {'battery h':>10s}")
    for r in top:
        print(f"{r['rank']:4d} {r['placement']:24s} "
              f"{r['avg_p_total_w'] * 1e3:9.3f} "
              f"{r['peak_p_total_w'] * 1e3:9.3f} {r['miss_windows']:5d} "
              f"{r['battery_h']:10.1f}")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    p = argparse.ArgumentParser(
        description="Trace-driven XR system simulation (repro_torch.trace)")
    p.add_argument("--scenario", default="gaming",
                   help="idle | gaming | passthrough | multi_user")
    p.add_argument("--placement", default="p1",
                   help="variant label, uniform tech, or level=tech,... ")
    p.add_argument("--arch", default="simba")
    p.add_argument("--node", type=int, default=7)
    p.add_argument("--mode", default="reload", help="sweep contention mode")
    p.add_argument("--duration", type=float, default=60.0,
                   help="scenario horizon in seconds")
    p.add_argument("--battery-mah", type=float, default=None,
                   help="battery budget (default 500 mAh)")
    p.add_argument("--trace-out", default=None,
                   help="write Chrome tracing JSON here")
    p.add_argument("--sweep", action="store_true",
                   help="rank the placement lattice by battery life")
    p.add_argument("--top", type=int, default=10,
                   help="rows to print in --sweep mode (0 = all)")
    p.add_argument("--out", default=None, help="write result rows as JSON")
    a = p.parse_args(argv)

    rows = sweep(a) if a.sweep else simulate_one(a)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"rows written to {a.out}")
    return rows


if __name__ == "__main__":
    main()
