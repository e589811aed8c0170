"""Chrome tracing JSON export for trace simulations.

``chrome_trace`` renders a
:class:`~repro_torch.trace.simulator.TraceTable` as a Trace Event Format
document (the JSON schema Perfetto and chrome://tracing consume): one
PROCESS per exported system, with

  * one THREAD (track) per stream — an ``"X"`` complete event per window
    the stream is active in, named ``"<stream> @ <ips> IPS"``,
  * ``standby`` / ``wake`` / ``reload`` tracks for the gating-model terms,
  * a ``deadline`` track with an ``"I"`` instant event per missed window,
  * ``"C"`` counter events for the per-window memory / total power.

Every event carries the four keys the format requires — ``ph``, ``ts``,
``pid``, ``tid`` — with timestamps in MICROseconds (the format's unit);
the CI smoke (``benchmarks/run.py trace_smoke``) validates exactly that
invariant on the emitted document.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.trace.simulator import TraceTable

_US = 1e6   # trace event timestamps are microseconds


def _label(point) -> str:
    return (f"{point.workload_name} [{point.arch}@{point.node}nm "
            f"{point.variant} {point.mode}]")


def _system_events(tab: TraceTable, i: int, pid: int) -> List[Dict[str, Any]]:
    point = tab.points[i]
    geom = tab.cols.geometry
    rows = [r for r in range(len(geom.sys_idx)) if geom.sys_idx[r] == i]
    streams = point.streams
    n = len(streams)
    tid_standby, tid_wake, tid_reload, tid_deadline = (n + 1, n + 2,
                                                       n + 3, n + 4)

    ev: List[Dict[str, Any]] = [
        dict(ph="M", name="process_name", pid=pid, tid=0, ts=0,
             args=dict(name=_label(point)))]
    tracks = [(k + 1, s.name) for k, s in enumerate(streams)]
    tracks += [(tid_standby, "standby"), (tid_wake, "wake"),
               (tid_reload, "reload"), (tid_deadline, "deadline")]
    for tid, name in tracks:
        ev.append(dict(ph="M", name="thread_name", pid=pid, tid=tid, ts=0,
                       args=dict(name=name)))

    t0 = tab.window_t0
    dur = tab.window_dur
    cols = tab.cols
    for w in range(tab.n_windows):
        ts, dus = int(round(t0[w] * _US)), int(round(dur[w] * _US))
        for k, r in enumerate(rows):
            ips = float(cols.rates[w, r])
            if ips > 0.0:
                ev.append(dict(
                    ph="X", name=f"{streams[k].name} @ {ips:g} IPS",
                    cat="stream", pid=pid, tid=k + 1, ts=ts, dur=dus,
                    args=dict(ips=ips, duty=float(cols.stream_duty[w, r]),
                              dyn_w=float(cols.stream_dyn_w[w, r]),
                              switch_per_s=float(cols.switch_rate[w, r]))))
        idle = float(cols.idle_frac[w, i])
        if idle > 0.0:
            ev.append(dict(
                ph="X", name=f"standby {idle:.0%}", cat="gating", pid=pid,
                tid=tid_standby, ts=ts, dur=dus,
                args=dict(idle_frac=idle,
                          standby_w=float(cols.standby_w[w, i]))))
        wake_rate = float(cols.wake_rate[w, i])
        if wake_rate > 0.0:
            ev.append(dict(
                ph="X", name=f"wake x{wake_rate:g}/s", cat="gating",
                pid=pid, tid=tid_wake, ts=ts, dur=dus,
                args=dict(wake_rate=wake_rate,
                          wake_j=float(cols.wake_j[w, i]))))
        reload_w = float(cols.reload_w[w, i])
        if reload_w > 0.0:
            ev.append(dict(
                ph="X", name="reload", cat="gating", pid=pid,
                tid=tid_reload, ts=ts, dur=dus,
                args=dict(reload_w=reload_w)))
        if cols.duty[w, i] > 1.0:
            ev.append(dict(
                ph="I", name=f"deadline miss (duty {cols.duty[w, i]:.2f})",
                cat="deadline", pid=pid, tid=tid_deadline, ts=ts, s="t",
                args=dict(duty=float(cols.duty[w, i]))))
        ev.append(dict(
            ph="C", name="power_w", pid=pid, tid=0, ts=ts,
            args=dict(p_mem_w=float(cols.p_mem_w[w, i]),
                      p_total_w=float(cols.p_total_w[w, i]))))
    # close the counter track at the horizon so the last window renders
    ev.append(dict(ph="C", name="power_w", pid=pid, tid=0,
                   ts=int(round(tab.scenario.duration_s * _US)),
                   args=dict(p_mem_w=0.0, p_total_w=0.0)))
    return ev


def chrome_trace(tab: TraceTable,
                 systems: Optional[Sequence[int]] = None) -> Dict[str, Any]:
    """Trace Event Format document for the given systems (default: all)."""
    if systems is None:
        systems = range(len(tab))
    events: List[Dict[str, Any]] = []
    for pid, i in enumerate(systems, start=1):
        events.extend(_system_events(tab, int(i), pid))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"scenario": tab.scenario.name,
                          "duration_s": tab.scenario.duration_s,
                          "battery_mah": tab.battery_mah}}


def write_chrome_trace(tab: TraceTable, path: str,
                       systems: Optional[Sequence[int]] = None) -> None:
    """Write the document to ``path`` (open in Perfetto / chrome://tracing)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tab, systems), f, indent=1)


def validate_events(doc: Dict[str, Any]) -> List[str]:
    """Schema check used by the CI smoke: every event must carry
    ``ph``/``ts``/``pid``/``tid``, complete events a ``dur``, timestamps
    non-negative ints. Returns a list of violations (empty = valid)."""
    errs: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for k, e in enumerate(events):
        for key in ("ph", "ts", "pid", "tid"):
            if key not in e:
                errs.append(f"event {k}: missing {key!r}")
        if not isinstance(e.get("ts"), int) or e.get("ts", 0) < 0:
            errs.append(f"event {k}: ts must be a non-negative int")
        if e.get("ph") == "X" and not isinstance(e.get("dur"), int):
            errs.append(f"event {k}: complete event without int dur")
    return errs
