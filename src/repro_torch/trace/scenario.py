"""XR load scenarios: frozen timelines of per-stream rate changes.

A :class:`Scenario` is a sequence of ``(t_start, {stream: ips})`` segments
over a fixed horizon. Segment semantics are *rate changes*, not full
vectors: at each ``t_start`` the named streams switch to their new rates
and every other stream HOLDS its previous rate (a stream is at 0.0 until
first mentioned). Rates of 0.0 mean the stream is off — no duty, no
dynamic energy, never switched into (``schedule.window_rollup``).

The library below encodes the phase structure reported for real XR
workloads ("Architectural Classification of XR Workloads", PAPERS.md) on
the paper's two applications: hand detection (detnet, IPS 10 min / 40
app) and eye segmentation (edsnet, IPS 0.1 min / 6 app).

``windows()`` yields the timeline as half-open constant-rate windows;
``canonical()`` merges adjacent equal-rate windows, which is what makes
the merge-invariance property exact: a subdivided scenario collapses to
the same canonical partition before any pricing happens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np

RateMap = Tuple[Tuple[str, float], ...]


def _as_ratemap(rates) -> RateMap:
    items = sorted(rates.items()) if isinstance(rates, dict) \
        else sorted(tuple(rates))
    for name, ips in items:
        if not isinstance(name, str) or not name:
            raise ValueError(f"Scenario: stream name must be a non-empty "
                             f"string, got {name!r}")
        if not (isinstance(ips, (int, float)) and math.isfinite(ips)
                and ips >= 0.0):
            raise ValueError(f"Scenario: stream {name!r} rate must be a "
                             f"finite number >= 0, got {ips!r}")
    return tuple((n, float(v)) for n, v in items)


@dataclass(frozen=True)
class Scenario:
    """A frozen timeline of per-stream rate changes over ``duration_s``."""
    name: str
    segments: Tuple[Tuple[float, RateMap], ...]
    duration_s: float

    def __post_init__(self):
        segs = tuple((float(t), _as_ratemap(r)) for t, r in self.segments)
        if not segs:
            raise ValueError(f"Scenario({self.name!r}): needs at least one "
                             f"segment")
        if segs[0][0] != 0.0:
            raise ValueError(f"Scenario({self.name!r}): first segment must "
                             f"start at t=0, got t={segs[0][0]!r}")
        for (t0, _), (t1, _) in zip(segs, segs[1:]):
            if not t1 > t0:
                raise ValueError(f"Scenario({self.name!r}): segment starts "
                                 f"must be strictly increasing, got "
                                 f"{t0!r} -> {t1!r}")
        if not (math.isfinite(self.duration_s)
                and self.duration_s > segs[-1][0]):
            raise ValueError(f"Scenario({self.name!r}): duration_s must "
                             f"exceed the last segment start "
                             f"({segs[-1][0]!r}), got {self.duration_s!r}")
        object.__setattr__(self, "segments", segs)
        object.__setattr__(self, "duration_s", float(self.duration_s))

    # --- construction -------------------------------------------------------
    @classmethod
    def constant(cls, rates, duration_s: float,
                 name: str = "constant") -> "Scenario":
        """One rate vector held for the whole horizon (the parity anchor)."""
        return cls(name, ((0.0, _as_ratemap(rates)),), duration_s)

    # --- views --------------------------------------------------------------
    @property
    def streams(self) -> Tuple[str, ...]:
        """Stream names in order of first appearance."""
        seen: List[str] = []
        for _, rm in self.segments:
            for n, _ in rm:
                if n not in seen:
                    seen.append(n)
        return tuple(seen)

    def windows(self) -> List[Tuple[float, float, Dict[str, float]]]:
        """Half-open constant-rate windows ``(t0, t1, {stream: ips})`` with
        hold-last semantics resolved (every window maps EVERY stream that
        appears anywhere in the scenario)."""
        names = self.streams
        cur = {n: 0.0 for n in names}
        out = []
        bounds = [t for t, _ in self.segments] + [self.duration_s]
        for (t0, rm), t1 in zip(self.segments, bounds[1:]):
            cur.update(dict(rm))
            out.append((t0, t1, dict(cur)))
        return out

    def rates_at(self, t: float) -> Dict[str, float]:
        """The full rate vector in effect at time ``t``."""
        if not 0.0 <= t < self.duration_s:
            raise ValueError(f"Scenario({self.name!r}): t={t!r} outside "
                             f"[0, {self.duration_s})")
        for t0, _t1, rates in reversed(self.windows()):
            if t >= t0:
                return rates
        raise AssertionError("unreachable")

    # --- canonicalization ---------------------------------------------------
    def canonical(self) -> "Scenario":
        """Merge adjacent equal-rate windows into one segment each.

        Two scenarios describing the same piecewise-constant rate function
        canonicalize to identical segment lists, so pricing a subdivided
        scenario is EXACTLY (bit-for-bit) pricing the original — the
        merge-invariance half of the trace parity oracle."""
        segs: List[Tuple[float, RateMap]] = []
        prev: RateMap = None
        for t0, _, rates in self.windows():
            rm = _as_ratemap(rates)
            if rm != prev:
                segs.append((t0, rm))
                prev = rm
        return replace(self, segments=tuple(segs))

    def subdivide(self, k: int) -> "Scenario":
        """Split every window into ``k`` equal sub-windows (same rates) —
        a different partition of the identical rate function."""
        if not (isinstance(k, int) and k >= 1):
            raise ValueError(f"Scenario.subdivide: k must be an int >= 1, "
                             f"got {k!r}")
        segs: List[Tuple[float, RateMap]] = []
        for t0, t1, rates in self.windows():
            rm = _as_ratemap(rates)
            for j in range(k):
                segs.append((t0 + (t1 - t0) * j / k, rm))
        return replace(self, segments=tuple(segs))

    def rate_matrix(self, names: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(t0s (W,), durations (W,), rates (W, len(names)))`` over the
        CANONICAL window partition, columns ordered as ``names`` (a name
        the scenario never mentions is 0.0 throughout)."""
        win = self.canonical().windows()
        t0s = np.array([t0 for t0, _, _ in win], float)
        durs = np.array([t1 - t0 for t0, t1, _ in win], float)
        mat = np.array([[r.get(n, 0.0) for n in names]
                        for _, _, r in win], float)
        return t0s, durs, mat


# ---------------------------------------------------------------------------
# scenario library (the paper's two applications; rates from experiment.py)
# ---------------------------------------------------------------------------


def _ips():
    from repro_torch.core.experiment import IPS_APP, IPS_MIN
    return IPS_MIN, IPS_APP


def idle(duration_s: float = 60.0) -> Scenario:
    """Headset worn but not interacted with: eye tracking keeps its minimum
    keep-alive rate; hand detection wakes for two brief presence sniffs.
    Dominated by the standby/retention term — where MRAM residency wins."""
    mn, _ = _ips()
    d, e = mn["detnet"], mn["edsnet"]
    return Scenario("idle", (
        (0.0, {"detnet": 0.0, "edsnet": e}),
        (20.0, {"detnet": d}),
        (22.0, {"detnet": 0.0}),
        (40.0, {"detnet": d}),
        (42.0, {"detnet": 0.0}),
    ), duration_s)


def gaming(duration_s: float = 60.0) -> Scenario:
    """Interaction-heavy session: hand detection at the application rate
    during interaction phases, saccade-triggered eye-segmentation bursts,
    a mid-session lull at the minimum rates."""
    mn, ap = _ips()
    return Scenario("gaming", (
        (0.0, {"detnet": ap["detnet"], "edsnet": mn["edsnet"]}),
        (8.0, {"edsnet": ap["edsnet"]}),          # saccade burst
        (10.0, {"edsnet": mn["edsnet"]}),
        (20.0, {"detnet": mn["detnet"]}),         # lull
        (30.0, {"detnet": ap["detnet"], "edsnet": ap["edsnet"]}),  # peak
        (33.0, {"edsnet": mn["edsnet"]}),
        (45.0, {"detnet": mn["detnet"]}),
        (52.0, {"detnet": ap["detnet"]}),
    ), duration_s)


def passthrough(duration_s: float = 60.0) -> Scenario:
    """Steady passthrough viewing at the paper's minimum rates — the
    constant-rate anchor that must reproduce the steady-state
    ``SystemPoint`` report byte-identically."""
    mn, _ = _ips()
    return Scenario.constant(
        {"detnet": mn["detnet"], "edsnet": mn["edsnet"]},
        duration_s, name="passthrough")


def multi_user(duration_s: float = 60.0) -> Scenario:
    """Device hand-off between two users: full-rate phases alternate
    between hand tracking and eye calibration, with brief overlap windows
    where BOTH run at application rates (the deadline-pressure corner)."""
    mn, ap = _ips()
    return Scenario("multi_user", (
        (0.0, {"detnet": ap["detnet"], "edsnet": 0.0}),
        (14.0, {"edsnet": ap["edsnet"]}),         # hand-off overlap
        (16.0, {"detnet": 0.0}),
        (30.0, {"detnet": ap["detnet"]}),         # second hand-off
        (32.0, {"edsnet": 0.0}),
        (46.0, {"detnet": mn["detnet"], "edsnet": mn["edsnet"]}),
    ), duration_s)


SCENARIOS = {
    "idle": idle,
    "gaming": gaming,
    "passthrough": passthrough,
    "multi_user": multi_user,
}


def get_scenario(name: str, **kw) -> Scenario:
    """Build a library scenario by name (``SCENARIOS`` keys)."""
    try:
        build = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(one of {sorted(SCENARIOS)})") from None
    return build(**kw)
