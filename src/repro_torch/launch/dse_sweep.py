"""The paper's full design-space exploration in one run, the port of
``examples/dse_sweep.py``: Fig 2(e/f), Fig 3(d), Fig 4, Fig 5 cross-overs,
Tables 2-3, then the beyond-paper sections (edge-LM KV cache, precision
axis, placement lattice, multi-stream system, a Pareto frontier, the
streaming joint-lattice frontier and the trace plane), printed as
readable tables.

    PYTHONPATH=src python -m repro_torch.launch.dse_sweep

Each figure/table is a declarative ``DesignSpace``
(``repro_torch.core.experiment.SWEEPS``); one shared ``Evaluator`` memoizes
workload extraction, buffer sizing and dataflow mapping across all of them,
and pricing is columnar. Everything runs in numpy on the host: every
figure is the model's estimate for an XR accelerator, not a measurement
of the machine this runs on. The printed sections are the example's, line
for line.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import nvm as nvm_mod
from repro_torch.core.experiment import (PLACEMENT_TECHS, SWEEPS, XR_BUNDLE,
                                         Evaluator, pmem_at)
from repro_torch.core.placement import Placement
from repro_torch.core.schedule import SystemPoint
from repro_torch.core.space import DesignSpace
from repro_torch.search import stream_frontier
from repro_torch.trace import get_scenario, simulate


def show(title, rows, cols):
    print(f"\n=== {title} ===")
    print("  ".join(f"{c:>12}" for c in cols))
    for r in rows:
        print("  ".join(f"{_fmt(r.get(c)):>12}" for c in cols))


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


def paper_sections(ev: Evaluator) -> None:
    """The sweeps' spaces, Fig 2f, Fig 3d, Fig 4 and Tables 2-3."""
    for sweep in SWEEPS.values():
        print(f"{sweep.figure:<55s} -> {sweep.space()!r}")

    show("Fig 2f: EDP vs node (SRAM-only)", SWEEPS["fig2f"].rows(ev),
         ["workload", "arch", "node", "energy_uj", "latency_ms", "edp"])
    show("Fig 3d: 9 variants x {28,7}nm", SWEEPS["fig3d"].rows(ev),
         ["workload", "node", "arch", "variant", "nvm", "energy_uj",
          "mem_uj"])
    show("Fig 4: read/write/compute", SWEEPS["fig4"].rows(ev),
         ["workload", "arch", "node", "variant", "read_uj", "write_uj",
          "compute_uj"])
    show("Table 2: area @7nm", SWEEPS["table2"].rows(ev),
         ["arch", "sram_mm2", "p0_mm2", "p1_mm2", "p0_savings",
          "p1_savings"])
    show("Table 3: P_mem savings @ IPS_min", SWEEPS["table3"].rows(ev),
         ["workload", "arch", "ips", "sram_latency_ms", "p0_latency_ms",
          "p1_latency_ms", "p0_savings", "p1_savings"])


def fig5_section(ev: Evaluator) -> None:
    """Fig 5, the columnar way: whole memory-power curves as one
    (points x IPS-grid) surface and every NVM-vs-SRAM cross-over in one
    batched bisection."""
    space5 = SWEEPS["fig5"].space()
    pts = list(space5)
    table = ev.evaluate_table(space5)
    ips_grid = np.logspace(-2, 2, 25)          # the figure's IPS axis
    power = table.memory_power_curves(ips_grid)
    mram, sram_rows = nvm_mod.sram_pairs(pts)
    xo = nvm_mod.crossover_ips_batch(table, mram, sram_rows)
    g1 = int(np.argmin(np.abs(ips_grid - 1.0)))  # the 1-IPS column

    print("\n=== Fig 5 (columnar): cross-over IPS (NVM wins below) ===")
    for k, i in enumerate(mram):
        p = pts[i]
        label = f"{p.workload_name:8s} {p.arch:8s} {p.variant} {p.nvm:6s}"
        pmem_1ips = power.p_mem_w[i, g1] * 1e6
        if np.isnan(xo[k]):
            print(f"  {label}: never saves      (P_mem@1ips "
                  f"{pmem_1ips:8.1f} uW)")
        else:
            print(f"  {label}: {xo[k]:8.2f} IPS  (P_mem@1ips "
                  f"{pmem_1ips:8.1f} uW)")


def beyond_paper_sections(ev: Evaluator) -> None:
    """The edge-LM KV cache, the precision axis, the placement lattice,
    the multi-stream system and the DetNet Pareto frontier at 7 nm."""
    print("\n=== Beyond-paper: edge-LM KV-cache DSE ===")
    for r in SWEEPS["lm_kv"].rows(ev, arch_names=("simba",),
                                  archs=("llama3.2-1b",)):
        print(f"  {r['model']} {r['variant']}/{r['device']:6s}: "
              f"savings@{r['savings_ips']:.3g}tok/s "
              f"{r['savings_at_ips']:+.0%}  crossover "
              f"{r['crossover_tok_s'] and round(r['crossover_tok_s'], 1)} "
              "tok/s")

    print("\n=== Precision axis (SWEEPS['quant']): simba @7nm ===")
    print(f"  {'workload':10s} {'corner':6s} {'variant':7s} "
          f"{'E (uJ)':>8s} {'area mm2':>9s} {'xover IPS':>10s}")
    for r in SWEEPS["quant"].rows(ev):
        if r["arch"] != "simba" or r["variant"] == "p0":
            continue
        xo = "-" if r["crossover_ips"] is None else f"{r['crossover_ips']:.1f}"
        print(f"  {r['workload']:10s} {r['precision']:6s} {r['variant']:7s} "
              f"{r['energy_uj']:8.1f} {r['total_mm2']:9.2f} {xo:>10s}")

    # the full per-level lattice (4 techs ^ 4 Simba levels = 256
    # hierarchies) against the paper's P0/P1 corners
    print("\n=== Placement lattice (simba @7nm): best hybrids vs P0/P1 ===")
    prows = SWEEPS["placement"].rows(ev)
    for w in ("detnet", "edsnet"):
        grp = sorted((r for r in prows if r["workload"] == w),
                     key=lambda r: r["p_mem_w"])
        c = grp[0]
        print(f"  {w} @ {c['ips']:g} IPS: P0 {c['p0_p_mem_w']*1e6:.0f} uW, "
              f"P1 {c['p1_p_mem_w']*1e6:.0f} uW; "
              f"{sum(r['beats_p0'] and r['beats_p1'] for r in grp)} hybrids "
              f"beat both")
        for r in grp[:3]:
            print(f"    {r['placement']:<48s} {r['p_mem_w']*1e6:7.1f} uW "
                  f"({r['savings']:+.0%} vs sram)  area "
                  f"{r['total_mm2']:.2f}mm2"
                  f"{'  *pareto' if r['pareto'] else ''}")

    # both XR workloads time-shared on one accelerator: shared standby
    # windows and per-context-switch weight reload
    print("\n=== Multi-stream system (simba @7nm): XR bundle, reload mode ===")
    srows = SWEEPS["system"].rows(ev)
    scorners = {r["placement"]: r for r in srows
                if r["placement"] in ("sram", "p0", "p1")}
    for v in ("sram", "p0", "p1"):
        r = scorners[v]
        print(f"  {v:4s}: P_mem {r['p_mem_w']*1e6:6.1f} uW "
              f"({r['savings']:+.0%} vs sram)  reload "
              f"{r['reload_uw']:5.1f} uW  duty {r['duty']:.4f}  "
              f"best-single {r['best_single_savings']:+.0%}"
              f"{'  >single' if r['beats_single'] else ''}")
    hyb = sorted((r for r in srows if r["placement"] not in scorners),
                 key=lambda r: r["p_mem_w"])
    n_beat = sum(r["beats_single"] for r in srows)
    print(f"  {n_beat} placements beat their best single-stream savings; "
          f"top hybrids:")
    for r in hyb[:3]:
        print(f"    {r['placement']:<48s} {r['p_mem_w']*1e6:7.1f} uW "
              f"({r['savings']:+.0%} sys vs {r['best_single_savings']:+.0%} "
              f"single)  area {r['total_mm2']:.2f}mm2")

    space = (SWEEPS["fig3d"].space()
             .where(lambda p: p.node == 7, lambda p: p.workload == "detnet"))
    front = ev.evaluate(space).pareto("edp", pmem_at(10.0))
    print("\n=== Pareto frontier (DetNet @7nm, EDP vs P_mem@10ips) ===")
    for p, r in front:
        print(f"  {p.arch:8s} {p.variant:4s}: edp={r.edp:.2e} J*s  "
              f"E={r.total_pj/1e6:.1f}uJ")

    info = ev.cache_info()
    print("\nevaluator cache (hits, misses): " +
          ", ".join(f"{k}={v}" for k, v in info.items()))


def joint_lattice() -> "DesignSpace":
    """The example's lazy joint lattice: DetNet on Eyeriss over pe config,
    weight and activation bits, node and every per-level placement."""
    return DesignSpace.product_iter(
        "joint", workload="detnet", arch="eyeriss", pe_config=("v1", "v2"),
        weight_bits=(None, 8, 4), act_bits=(None, 8, 4), node=(45, 28, 7),
        placement=Placement.enumerate("eyeriss", PLACEMENT_TECHS))


def streaming_section(ev: Evaluator):
    """The joint lattice streamed through the chunked columnar pricer into
    an (EDP, P_mem@10ips) Pareto archive; survivors materialize by
    ``point_at``. Returns the lattice and the archive."""
    joint = joint_lattice()
    arc = stream_frontier(ev, joint, objectives=("edp", "pmem"), ips=10.0,
                          min_ips=10.0)
    print(f"\n=== streaming frontier: {len(joint):,}-point joint lattice -> "
          f"{len(arc)} designs ({arc.dropped:,} infeasible) ===")
    for i, (edp, pmem) in zip(*arc.frontier()):
        p = joint.point_at(int(i))
        print(f"  {p.arch:8s} {p.node:2d}nm {p.variant:<44s} "
              f"{p.precision_label:5s} edp={edp:.2e} J*s  "
              f"P_mem={pmem*1e6:.1f} uW")
    return joint, arc


def trace_section(ev: Evaluator):
    """The gaming scenario on the SRAM/P0/P1 corners (every window x
    system in one pass), then the idle scenario's battery-life ranking of
    the placement lattice. Returns (the gaming table, the idle rows)."""
    scenario = get_scenario("gaming")
    corners = [SystemPoint(XR_BUNDLE, "simba", 7, variant=v, mode="reload")
               for v in ("sram", "p0", "p1")]
    ttab = simulate(ev, corners, scenario)
    print(f"\n=== trace: {scenario.name} ({scenario.duration_s:g}s, "
          f"{ttab.n_windows} windows, {ttab.battery_mah:g} mAh) ===")
    for i, p in enumerate(ttab.points):
        r = ttab.report(i)
        print(f"  {p.variant:4s}: avg {r.avg_p_total_w*1e3:6.3f} mW  "
              f"peak {r.peak_p_total_w*1e3:6.3f} mW  "
              f"p99 {r.p99_p_total_w*1e3:6.3f} mW  "
              f"misses {r.miss_windows}  battery {r.battery_h:7.1f} h")

    trows = SWEEPS["trace"].rows(ev, scenario="idle")
    best, worst = trows[0], trows[-1]
    print(f"\nidle-scenario battery life: best {best['placement']} "
          f"{best['battery_h']:.0f} h vs worst {worst['placement']} "
          f"{worst['battery_h']:.0f} h "
          f"(+{best['battery_h']/worst['battery_h']-1:.0%})")
    return ttab, trows


def main() -> Evaluator:
    ev = Evaluator()
    paper_sections(ev)
    fig5_section(ev)
    beyond_paper_sections(ev)
    streaming_section(ev)
    trace_section(ev)
    return ev


if __name__ == "__main__":
    main()
