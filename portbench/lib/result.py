"""The result line of a run."""
from __future__ import annotations

import math
import sys
from typing import Dict

from portbench.lib.bench import by_prefix
from portbench.lib.outcome import Outcome, context


def _num(x: float) -> float:
    """A reading that JSON can hold: an infinite or undefined one is
    written as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def line(cell, outcome: Outcome, trace: bool, setup_s: float, kind: str
         ) -> Dict:
    """``kind``: the card's name, as ``torch.cuda.get_device_name`` gives it."""
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    metrics: Dict[str, Dict] = {}
    out: Dict = {}
    if trace:
        s = outcome.window.summary
        dev["busy_s"] = s.busy_us / 1e6
        dev["window_s"] = s.window_us / 1e6
        ctx = context(outcome, kind)
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = s.breakdown()
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": by_prefix(m["name"], values),
                                  "unit": m["unit"]}
    return {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev,
            **out,
            "checks": {k: {"value": _num(v), "limit": lim}
                       for k, (v, lim) in outcome.checks.items()}}
