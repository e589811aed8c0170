"""Grid-search device constants against the paper's Table 2/3 targets,
the port of ``tools/gridsearch.py``.

Tunes ONLY device-table constants (leakage, cell-energy fraction, VGSOT
asymmetry) — never the dataflow mechanics — and prints the best configs.
Runs on the columnar pricing core (``repro_torch.core``) with a single
shared ``Evaluator``: workload extraction, suite buffer sizing, arch
construction, dataflow mapping AND the space's flattened ``PricingPlan``
are memoized ONCE across the whole grid (all pure geometry, untouched by
device-constant mutation), so each grid cell is one vectorized
``EnergyTable`` pricing plus a batched savings computation.

    PYTHONPATH=src python -m repro_torch.launch.gridsearch [--limit N]
        [--top K] [--weight-bits 4] [--act-bits 8]
        [--placement weight=stt,unified=sot] [--system]

``--weight-bits/--act-bits`` re-bind the scoring space to a precision
corner (the targets stay the paper's INT8 numbers — a probe for how far
quantization moves the savings bands, not a fit).
``--placement SEL=TECH[,SEL=TECH...]`` swaps the space's P1 variant for a
custom per-level placement — a probe for how a hybrid hierarchy would move
the p1 band under each device-constant cell. The scoring space covers BOTH
systolic archs, so use class selectors (weight/input/output/unified) or
level names they share (``gwb``); a simba-only level name like
``input_buf`` fails with the hierarchy named.
``--system`` additionally prices the best cell at SYSTEM level: the paper
XR bundle time-shared on one accelerator (core.schedule), a probe with no
paper targets.

Everything runs in numpy on the host: the savings are the model's
estimates for the XR accelerators it prices, not measurements of the
machine this runs on.
"""
import argparse
import itertools
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import devices as dev
from repro_torch.core import nvm as nvm_mod
from repro_torch.core.experiment import (IPS_MIN, XR_BUNDLE, Evaluator,
                                         table3_space)
from repro_torch.core.placement import Placement
from repro_torch.core.schedule import SystemPoint

T3 = {  # (workload, arch) -> (p0_sav, p1_sav)
    ("detnet", "simba"): (0.27, 0.31),
    ("detnet", "eyeriss"): (-0.04, 0.09),
    ("edsnet", "simba"): (0.29, 0.24),
    ("edsnet", "eyeriss"): (-0.15, -0.26),
}

GRID = dict(
    leak=[0.008, 0.016, 0.030, 0.050],
    cf_min=[0.10, 0.20, 0.30],
    cf_slope=[0.20, 0.30, 0.40],
    vg_read=[1.8, 2.4, 3.0],
    vg_write=[0.55, 0.80],
)

def parse_placement(s: str) -> Placement:
    """``"gwb=stt,input_buf=sot"`` -> an ordered per-level ``Placement``
    (selectors are level names, level classes or ``*``)."""
    entries = []
    for part in s.split(","):
        sel, _, tech = part.partition("=")
        if not tech:
            raise ValueError(f"--placement entry {part!r}: want SEL=TECH")
        entries.append((sel.strip(), tech.strip()))
    return Placement.per_level(entries)


def build_space(weight_bits=None, act_bits=None, placement=None):
    """The Table-3 scoring space, optionally at a precision corner
    (``--weight-bits/--act-bits``): same structure, every point re-bound to
    the given operand widths (None keeps the paper's INT8). ``placement``
    (a ``Placement`` or ``SEL=TECH,...`` string) swaps the P1 variant for a
    custom hierarchy — the placement probe."""
    space = table3_space(node=7)
    if weight_bits is not None or act_bits is not None:
        space = space.map(lambda p: p.with_(weight_bits=weight_bits,
                                            act_bits=act_bits))
    if placement is not None:
        if isinstance(placement, str):
            placement = parse_placement(placement)
        space = space.map(lambda p: p.with_(placement=placement)
                          if p.variant == "p1" else p)
    return space


def build_indices(space):
    """Row indices for the vectorized score: per (workload, arch) pair the
    (sram, p0, third-variant) rows — the third variant is p1 or the
    ``--placement`` probe — plus flat (nvm, sram, ips) arrays for the
    batched savings call. Pure structure — computed once per space."""
    by = {}
    for i, p in enumerate(space):
        by.setdefault((p.workload_name, p.arch), {})[p.variant] = i
    pairs = []
    for (w, a) in T3:
        d = by[(w, a)]
        third = next(v for v in d if v not in ("sram", "p0"))
        pairs.append((w, a, d["sram"], d["p0"], d[third]))
    nvm_rows = np.array([r for (_, _, _, p0, p1) in pairs for r in (p0, p1)])
    sram_rows = np.array([s for (_, _, s, _, _) in pairs for _ in (0, 1)])
    ips = np.array([IPS_MIN[w] for (w, _, _, _, _) in pairs for _ in (0, 1)])
    return pairs, nvm_rows, sram_rows, ips


SPACE = build_space()
_PAIRS, _NVM_ROWS, _SRAM_ROWS, _IPS = build_indices(SPACE)


def score(ev: Evaluator, space=None, indices=None):
    """Squared error of the Table-3 savings grid vs the paper targets.

    Columnar: one vectorized ``EnergyTable`` for the whole space, one
    batched savings evaluation for all 8 (variant, baseline) pairs.
    ``space``/``indices`` select a precision corner (default: INT8; the
    paper targets are INT8 numbers — at other corners the error column is
    a how-far-does-quantization-move-the-bands probe, not a fit)."""
    if space is None:
        space, indices = SPACE, (_PAIRS, _NVM_ROWS, _SRAM_ROWS, _IPS)
    elif indices is None:
        indices = build_indices(space)
    pairs, nvm_rows, sram_rows, ips = indices
    table = ev.evaluate_table(space)
    s = nvm_mod.savings_at_ips_batch(table, nvm_rows, sram_rows, ips)
    err = 0.0
    out = {}
    for k, (w, a, *_rows) in enumerate(pairs):
        s0, s1 = float(s[2 * k]), float(s[2 * k + 1])
        out[(w, a)] = (s0, s1)
        t0, t1 = T3[(w, a)]
        err += (s0 - t0) ** 2 + (s1 - t1) ** 2
    return err, out


def score_reports(ev: Evaluator):
    """Row-view path: ``ev.evaluate()`` (columnar pricing inside, but
    materializing per-point ``EnergyReport`` views) + scalar savings.
    It carries the dataclass-materialization overhead the pure-table
    ``score`` avoids."""
    err = 0.0
    out = {}
    results = ev.evaluate(SPACE)
    for (w, a), group in results.groupby("workload", "arch").items():
        reps = {p.variant: r for p, r in group}
        ips = IPS_MIN[w]
        s0 = nvm_mod.savings_at_ips(reps["p0"], reps["sram"], ips)
        s1 = nvm_mod.savings_at_ips(reps["p1"], reps["sram"], ips)
        out[(w, a)] = (s0, s1)
        t0, t1 = T3[(w, a)]
        err += (s0 - t0) ** 2 + (s1 - t1) ** 2
    return err, out


def apply_knobs(leak, cfm, cfs, vr, vw):
    dev.SRAM_LEAK_UW_PER_KB_45 = leak
    dev.CELL_FRAC_MIN = cfm
    dev.CELL_FRAC_SLOPE = cfs
    dev.DEVICES["vgsot"] = dev.MemDevice("vgsot", vr, vw, 0.0, 1 / 2.3,
                                         1, 2, True)


def system_probe(ev: Evaluator, arch_names=("simba", "eyeriss"),
                 node: int = 7, quiet=False):
    """Multi-stream probe under the CURRENT device tables: the paper XR
    bundle (detnet@10 + edsnet@0.1 time-shared, core.schedule) priced as
    sram/p0/p1 systems per arch. Returns {(arch, variant): system savings
    vs the all-SRAM system} — how a knob combo moves the SYSTEM-level
    bands, which fold in standby sharing and weight-reload elimination on
    top of the single-stream Table-3 fit."""
    out = {}
    for a in arch_names:
        spts = [SystemPoint(XR_BUNDLE, a, node, v)
                for v in ("sram", "p0", "p1")]
        tab = ev.system_table(spts)
        for i, v in enumerate(("p0", "p1")):
            out[(a, v)] = float(1.0 - tab.p_mem_w[i + 1] / tab.p_mem_w[0])
        if not quiet:
            print(f"   system {a:8s}: "
                  f"p0 {out[(a, 'p0')]:+.1%}  p1 {out[(a, 'p1')]:+.1%}  "
                  f"(reload@sram "
                  f"{float(tab.reload_w[0])*1e6:.1f} uW, duty "
                  f"{float(tab.duty[0]):.4f})")
    return out


def run(limit=None, top=8, quiet=False, weight_bits=None, act_bits=None,
        placement=None, system=False):
    # Structural caches survive device-table mutation (they are geometry
    # only); report caching must stay OFF under mutation.
    ev = Evaluator(cache_reports=False)
    space = build_space(weight_bits, act_bits, placement)
    indices = build_indices(space)
    saved = (dev.SRAM_LEAK_UW_PER_KB_45, dev.CELL_FRAC_MIN,
             dev.CELL_FRAC_SLOPE, dev.DEVICES["vgsot"])
    results = []
    combos = itertools.product(*GRID.values())
    if limit is not None:
        combos = itertools.islice(combos, limit)
    last_exc = None
    try:
        for knobs in combos:
            apply_knobs(*knobs)
            try:
                err, out = score(ev, space, indices)
            except Exception as e:        # a knob combo can be degenerate
                last_exc = e
                continue
            results.append((err, knobs, out))
    finally:
        (dev.SRAM_LEAK_UW_PER_KB_45, dev.CELL_FRAC_MIN,
         dev.CELL_FRAC_SLOPE, dev.DEVICES["vgsot"]) = saved

    if not results and last_exc is not None:
        # every cell failed: that is a broken SPACE (e.g. a --placement
        # naming levels one arch lacks), not a degenerate knob combo
        raise last_exc
    results.sort(key=lambda r: r[0])
    if not quiet:
        for err, knobs, out in results[:top]:
            print(f"err={err:.4f} leak={knobs[0]} cf_min={knobs[1]} "
                  f"cf_slope={knobs[2]} vg_r={knobs[3]} vg_w={knobs[4]}")
            for k, v in out.items():
                t = T3[k]
                print(f"   {k[0]:8s}/{k[1]:8s}: p0={v[0]:+.1%} (t {t[0]:+.0%})  "
                      f"p1={v[1]:+.1%} (t {t[1]:+.0%})")
    if system:
        # system mode: re-apply the best cell's knobs and report how they
        # move the MULTI-STREAM bands (no paper targets exist at system
        # level — this is a probe, not a fit term). Return shape is fixed
        # by the flag, not by whether any cell survived.
        results_system = {}
        if results:
            if not quiet:
                print("-- system probe (best cell): XR bundle, "
                      "time-shared --")
            try:
                apply_knobs(*results[0][1])
                results_system = system_probe(ev, quiet=quiet)
            finally:
                (dev.SRAM_LEAK_UW_PER_KB_45, dev.CELL_FRAC_MIN,
                 dev.CELL_FRAC_SLOPE, dev.DEVICES["vgsot"]) = saved
        return results, results_system
    return results


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N grid cells")
    p.add_argument("--top", type=int, default=8)
    p.add_argument("--weight-bits", type=int, default=None,
                   help="score the grid at this stored weight width "
                        "(default: the paper's INT8)")
    p.add_argument("--act-bits", type=int, default=None,
                   help="score the grid at this stored activation width")
    p.add_argument("--placement", default=None, metavar="SEL=TECH,...",
                   help="swap the p1 variant for a custom per-level "
                        "placement (probe, e.g. weight=stt,unified=sot; "
                        "class selectors span both archs)")
    p.add_argument("--system", action="store_true",
                   help="also probe the best cell at SYSTEM level: the XR "
                        "bundle (detnet@10 + edsnet@0.1) time-shared per "
                        "arch (core.schedule)")
    a = p.parse_args(argv)
    return run(limit=a.limit, top=a.top, weight_bits=a.weight_bits,
               act_bits=a.act_bits, placement=a.placement, system=a.system)


if __name__ == "__main__":
    main()
