"""Hillclimb search with three modes, the port of ``tools/hillclimb.py``.

Roofline mode (default): trace ONE dry-run cell with config and rule
overrides on the production mesh and print its modelled H100 roofline
terms. ``--profile`` prints the per-device byte table by op from the
dry-run's tally (unfused aten inputs and outputs, and the kernels'), in
place of the reference's HLO profile. It runs on torch's fake process
group, so as its own process.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch gemma2-9b --shape decode_32k [--multi-pod] \\
        [--set swa_ring_buffer=True] [--rule expert_cap=pod,data] [--profile]

DSE mode (--dse): greedy local search over the paper's design space
{arch x node x variant x NVM device x PE config} for one workload, driven
by the experiment API — every candidate neighborhood is one columnar
pricing and all structural work is memoized by one ``Evaluator``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --dse \\
        --workload detnet [--objective edp|energy|pmem] [--ips 10]

System mode (--system): the same greedy search on the MULTI-STREAM plane
(core.schedule): a bundle of concurrent workloads time-shared on one
accelerator, moving (arch, node, pe_config, contention mode, per-level
placement) to minimize feasible system memory power.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --system \\
        [--stream detnet=10 --stream edsnet=0.1]

The DSE and system modes run in numpy on the host and need no process
group; their figures are the model's estimates for the XR accelerators it
prices, not measurements of the machine this runs on.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import roofline as rl
from repro_torch.launch import dryrun
from repro_torch.core.experiment import XR_BUNDLE, Evaluator
from repro_torch.core.schedule import Stream, SystemPoint
from repro_torch.core.space import DesignPoint
from repro_torch.launch import mesh as mesh_mod
from repro_torch.search import moves


def parse_override(s: str):
    k, v = s.split("=", 1)
    with contextlib.suppress(Exception):
        v = eval(v, {}, {})
    return k, v


def profile(tally, top: int = 18) -> None:
    """Bytes by op name (per device, unfused) and the kernels' launches."""
    print("\n-- bytes by op (per device, unfused aten inputs+outputs; "
          "kernels' own) --")
    for op, b in sorted(tally.by_op.items(), key=lambda x: -x[1])[:top]:
        print(f"   {op:<28}{b/1e9:10.2f} GB")
    print("-- kernels (launches, GFLOP, GB) --")
    for name, (n, ops, nb) in sorted(tally.kernels.items()):
        print(f"   {name:<28}{n:6d}{ops/1e9:12.1f}{nb/1e9:10.2f}")


# ---------------------------------------------------------------------------
# DSE mode: greedy local search over the experiment design space
# ---------------------------------------------------------------------------

# The move generators live in repro_torch.search.moves (shared with the
# population optimizer); these module-level names are the tool's import
# surface, which the system mode uses too.
def _arch_move(point, arch_name):
    return moves.arch_move(point, arch_name)


def placement_moves(point, techs=None):
    return moves.placement_moves(point, techs)


def __getattr__(name):
    if name == "DSE_AXES":
        return moves.DSE_AXES
    raise AttributeError(name)


def dse_main(a):
    """Greedy local search on the COLUMNAR path (``search.moves.greedy``):
    every neighborhood is one ``EnergyTable`` pricing (a single vectorized
    pass over ~30 points) and the objective is a table column."""
    if a.objective == "edp":
        metric = "edp"
        fmt = lambda v: f"edp={v:.3e} J*s"
    elif a.objective == "energy":
        metric = "total_pj"
        fmt = lambda v: f"E={v/1e6:.2f} uJ"
    else:
        metric = "pmem"
        fmt = lambda v: f"P_mem@{a.ips}ips={v*1e6:.1f} uW"

    ev = Evaluator()
    start = DesignPoint(workload=a.workload, arch="cpu", node=45,
                        variant="sram")
    t0 = time.monotonic()
    print(f"=== DSE hillclimb: {a.workload}, objective {a.objective} ===")

    def on_step(step, p, v):
        print(f"  step {step}: {p.arch}/{p.node}nm/{p.variant}"
              f"/{p.nvm or 'auto'}/{p.pe_config}/{p.precision_label}"
              f"  {fmt(v)}")

    p, val, steps = moves.greedy(ev, start, metric=metric, ips=a.ips,
                                 on_step=on_step)
    table = ev.evaluate_table([p])
    hits, misses = ev.cache_info()["traffic"]
    print(f"\nlocal optimum after {steps} steps "
          f"({time.monotonic()-t0:.1f}s, traffic cache {hits}h/{misses}m):")
    print(f"  {p.arch} @ {p.node}nm, {p.variant}/{p.nvm or 'auto'}, "
          f"pe={p.pe_config}, {p.precision_label}: {fmt(val)}  "
          f"lat={float(table.latency_s[0])*1e3:.2f}ms  "
          f"E={float(table.total_pj[0])/1e6:.2f}uJ")
    return p, val, steps


# ---------------------------------------------------------------------------
# system mode: greedy search over the multi-stream plane (core.schedule)
# ---------------------------------------------------------------------------

SYSTEM_AXES = dict(
    node=(45, 40, 28, 22, 7),
    pe_config=("v1", "v2"),
    mode=("reload", "union"),
)


def parse_streams(specs):
    """``["detnet=10", "edsnet=0.1"]`` -> Stream tuple."""
    out = []
    for s in specs:
        name, _, ips = s.partition("=")
        if not ips:
            raise ValueError(f"--stream {s!r}: want WORKLOAD=IPS")
        out.append(Stream(name.strip(), float(ips)))
    return tuple(out)


def system_main(a):
    """Greedy local search over the SYSTEM design space: the stream bundle
    stays fixed, (arch, node, pe_config, contention mode, per-level
    placement) move. Each neighborhood is ONE ``SystemTable`` pricing;
    infeasible systems (sum of duties > 1) are never selected."""
    streams = parse_streams(a.stream) if a.stream else XR_BUNDLE
    ev = Evaluator()

    def best_of(points):
        tab = ev.system_table(points)
        vals = np.where(tab.feasible, tab.p_mem_w, np.inf)
        i = int(np.argmin(vals))
        return points[i], float(vals[i]), (tab, i)

    point = SystemPoint(streams, "simba", 45, "sram")
    best = best_of([point])
    if not np.isfinite(best[1]):
        raise SystemExit(f"stream bundle {[s.name for s in streams]} is "
                         f"infeasible even on the starting system")
    label = "+".join(f"{s.name}@{s.ips:g}" for s in streams)
    print(f"=== system hillclimb: {label}, objective P_mem ===")
    t0 = time.monotonic()
    step = 0
    while True:
        cur = best[0]
        neighbors = [cur.with_(**{axis: v})
                     for axis, values in SYSTEM_AXES.items()
                     for v in values if v != getattr(cur, axis)]
        neighbors += [_arch_move(cur, v) for v in moves.DSE_AXES["arch"]
                      if v != cur.arch]
        neighbors += placement_moves(cur)
        cand = best_of([cur] + neighbors)
        if cand[1] >= best[1]:
            break
        best = cand
        step += 1
        p = best[0]
        print(f"  step {step}: {p.arch}/{p.node}nm/{p.mode}/{p.variant}"
              f"  P_mem={best[1]*1e6:.1f} uW")
    p, val, (tab, i) = best
    print(f"\nlocal optimum after {step} steps "
          f"({time.monotonic()-t0:.1f}s):")
    print(f"  {p.arch} @ {p.node}nm, mode={p.mode}, {p.variant}: "
          f"P_mem={val*1e6:.1f} uW  duty={float(tab.duty[i]):.4f}  "
          f"reload={float(tab.reload_w[i])*1e6:.2f} uW")
    return p, val, step


# ---------------------------------------------------------------------------
# roofline mode (dry-run trace probe)
# ---------------------------------------------------------------------------

def roofline_main(a) -> rl.Roofline:
    cfg = get_config(a.arch)
    if a.set:
        cfg = dataclasses.replace(cfg, **dict(parse_override(s)
                                              for s in a.set))
    rules = mesh_mod.shape_rules(cfg, a.shape) or {}
    for r in a.rule:
        k, v = r.split("=", 1)
        rules[k] = tuple(v.split(",")) if v else None
    shape, _ = mesh_mod.production_shape(a.multi_pod)
    n = 1
    for d in shape:
        n *= d
    t0 = time.monotonic()
    with dryrun.fake_group(n):
        mesh = mesh_mod.make_production_mesh(multi_pod=a.multi_pod,
                                             device_type="cpu")
        flops, byts, coll, by_kind, t2, _ = dryrun.extrapolated(
            cfg, a.shape, mesh, rules)
    r = rl.Roofline(a.arch, a.shape, "x".join(map(str, shape)), n,
                    flops * n, byts * n, coll * n, by_kind,
                    mesh_mod.model_flops(cfg, a.shape))
    print(f"\n=== {a.arch} x {a.shape} overrides={a.set} rules={a.rule} "
          f"({time.monotonic()-t0:.0f}s; modelled H100 roofline) ===")
    print(f"t_compute={r.t_compute*1e3:.2f}ms t_memory={r.t_memory*1e3:.2f}ms "
          f"t_collective={r.t_collective*1e3:.2f}ms bound={r.bottleneck}")
    print(f"useful={r.useful_flop_frac:.3f} roofline_frac={r.roofline_frac:.5f}")
    print("collectives/dev: " + ", ".join(
        f"{k}={v/1e9:.2f}GB" for k, v in by_kind.items() if v))
    if a.profile:
        profile(t2)
    return r


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--dse", action="store_true",
                   help="hillclimb the edge-DSE design space instead")
    p.add_argument("--system", action="store_true",
                   help="hillclimb the multi-stream SYSTEM plane (one "
                        "accelerator time-shared by --stream bundles)")
    p.add_argument("--stream", action="append", default=[],
                   metavar="WORKLOAD=IPS",
                   help="[system] stream spec (repeatable; default: the "
                        "paper XR bundle detnet=10, edsnet=0.1)")
    p.add_argument("--workload", default="detnet",
                   help="[dse] workload / config name")
    p.add_argument("--objective", default="edp",
                   choices=("edp", "energy", "pmem"))
    p.add_argument("--ips", type=float, default=10.0,
                   help="[dse] inference rate for the pmem objective")
    p.add_argument("--arch", help="[roofline] LM config name")
    p.add_argument("--shape", help="[roofline] input shape set")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--set", action="append", default=[],
                   help="cfg field override, e.g. swa_ring_buffer=True")
    p.add_argument("--rule", action="append", default=[],
                   help="sharding rule override, e.g. expert_cap=pod,data")
    p.add_argument("--profile", action="store_true")
    a = p.parse_args(argv)
    if a.system:
        return system_main(a)
    if a.dse:
        return dse_main(a)
    if not (a.arch and a.shape):
        p.error("roofline mode needs --arch and --shape (or use --dse)")
    return roofline_main(a)


if __name__ == "__main__":
    main()
