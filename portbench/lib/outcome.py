"""What a driver hands back, what the per-layer readers read, the checks
that decide ``correct``, and the device's published peaks."""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional, Tuple

from portbench.lib.tracing import Summary
from portbench.lib.window import Window

# Published dense peaks of the cards a cell may run on (the vendor's data
# sheet, full power limit): float32 outside the tensor cores, HBM bytes/s.
PEAKS = {"NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12}}


@dataclass
class Outcome:
    kind: str                          # "train" or "infer"
    batch: int
    window: Window
    end_to_end: Dict[str, float]       # the driver's own end-to-end metrics
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: Dict[str, Tuple[float, float]]   # name -> (value, limit)
    counts: Dict[str, object] = field(default_factory=dict)
    where: Dict[str, str] = field(default_factory=dict)  # check -> worst part
    setup: Dict[str, float] = field(default_factory=dict)  # phase -> seconds

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


@dataclass
class Context:
    """What a per-layer metric's ``read(ctx)`` is given."""
    kind: str
    batch: int
    units: int                  # steps or requests in the window
    items: int
    seconds: float              # the window's length
    summary: Optional[Summary]  # the traced segment
    counts: Mapping[str, object]
    peaks: Optional[Mapping[str, float]]


def context(outcome: Outcome, device_kind: str) -> Context:
    w = outcome.window
    return Context(outcome.kind, outcome.batch, w.units, w.items, w.elapsed,
                   w.summary, outcome.counts, PEAKS.get(device_kind))


def leaf_gap(prog: Mapping, ref: Mapping, keys: Iterable[str]
             ) -> Tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; returns (gap, leaf)."""
    keys = list(keys)
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(rn.values())
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
        if gap > worst or not at:
            worst, at = gap, k
    return worst, at
