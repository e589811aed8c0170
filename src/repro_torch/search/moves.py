"""Move generators over the joint design space + the greedy walker.

Extracted from ``tools/hillclimb.py`` so both the CLI hillclimb and the
population optimizer (``repro_torch.search.evolve``) share ONE neighborhood
definition: per-axis field moves, arch moves that drop level-NAME placement
entries the new hierarchy lacks, and single-level technology re-assignments
(``Placement.with_level``). The move set works for ``DesignPoint`` and the
system plane's ``SystemPoint`` alike (both expose ``with_``/``arch_spec``/
``placement``), which is what lets ``hillclimb --system`` reuse it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.placement import Placement

# The DSE plane's axis menu: field values a local move may flip to.
# Precision values: None = the specs' INT8 default (an explicit 8 would
# only duplicate it); sizing, traffic and area all respond (DESIGN.md §5).
DSE_AXES: Dict[str, Tuple[Any, ...]] = dict(
    arch=("cpu", "eyeriss", "simba"),
    node=(45, 40, 28, 22, 7),
    variant=("sram", "p0", "p1"),
    nvm=(None, "stt", "sot", "vgsot"),
    pe_config=("v1", "v2"),
    weight_bits=(None, 4),
    act_bits=(None, 4),
)


def arch_move(point, arch_name: str):
    """Arch-axis neighbor: level-NAME placement entries do not transfer
    between hierarchies, so drop the ones the new arch lacks (class/'*'
    selectors and the paper-variant shapes carry over untouched)."""
    moved = point.with_(arch=arch_name)
    arch = moved.arch_spec()
    keep = ({l.name for l in arch.levels} | {l.cls for l in arch.levels}
            | {"*"})
    entries = tuple(e for e in point.placement.entries if e[0] in keep)
    if entries == point.placement.entries:
        return moved
    return moved.with_(
        placement=Placement.per_level(entries, nvm=point.placement.nvm))


def placement_moves(point, techs: Optional[Sequence[str]] = None) -> List:
    """Neighbors that re-assign ONE memory level's technology
    (``Placement.with_level``) over the lattice menu
    (``experiment.PLACEMENT_TECHS`` — the placement dimension, DESIGN.md
    §6 §Placement), skipping no-op moves against the point's
    currently-resolved per-level techs."""
    from repro_torch.core import devices as dev
    from repro_torch.core.experiment import PLACEMENT_TECHS

    if techs is None:
        techs = PLACEMENT_TECHS
    arch = point.arch_spec()
    default = point.nvm or dev.PAPER_NVM_AT_NODE.get(point.node, "stt")
    current = point.placement.techs_for(arch.levels, default_nvm=default)
    return [point.with_(placement=point.placement.with_level(lvl.name, tech))
            for lvl, cur in zip(arch.levels, current)
            for tech in techs if tech != cur]


def axis_moves(point, axes: Optional[Dict[str, Tuple]] = None) -> List:
    """Single-field neighbors over every non-arch axis of ``axes``."""
    if axes is None:
        axes = DSE_AXES
    return [point.with_(**{axis: v})
            for axis, values in axes.items() if axis != "arch"
            for v in values if v != getattr(point, axis)]


def neighbors(point, axes: Optional[Dict[str, Tuple]] = None,
              techs: Optional[Sequence[str]] = None) -> List:
    """The full 1-move neighborhood: axis moves + arch moves + per-level
    placement moves (the hillclimb hood, current point excluded)."""
    if axes is None:
        axes = DSE_AXES
    out = axis_moves(point, axes)
    out += [arch_move(point, v) for v in axes.get("arch", ())
            if v != point.arch]
    out += placement_moves(point, techs)
    return out


def greedy(ev, start, metric: str = "edp", ips: float = 10.0,
           axes: Optional[Dict[str, Tuple]] = None,
           techs: Optional[Sequence[str]] = None,
           on_step=None):
    """Greedy local search on the COLUMNAR path: every neighborhood is one
    ``EnergyTable`` pricing (a single vectorized pass over ~30 points) and
    the objective is a table column. Returns (point, value, steps).

    ``metric`` is any ``EnergyTable.column`` name (``'pmem'`` uses
    ``ips``); ``on_step(step, point, value)`` observes each improvement.
    """
    from repro_torch.core.space import DesignSpace

    def best_of(pts):
        table = ev.evaluate_table(DesignSpace.from_points(pts, name="hood"))
        vals = table.column(metric, ips=ips)
        i = int(np.argmin(vals))
        return table.points[i], float(vals[i])

    best_p, best_v = best_of([start])
    steps = 0
    while True:
        cand_p, cand_v = best_of([best_p] + neighbors(best_p, axes, techs))
        if cand_v >= best_v:
            return best_p, best_v, steps
        best_p, best_v = cand_p, cand_v
        steps += 1
        if on_step:
            on_step(steps, best_p, best_v)
