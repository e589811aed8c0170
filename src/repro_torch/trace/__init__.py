"""Trace-driven dynamic XR system simulation (DESIGN.md §11).

The steady-state system plane (``core.schedule``) prices concurrent
workloads at FIXED rates; real XR load is bursty and phase-dependent
(saccade-triggered eye segmentation, hand detection only during
interaction). This package adds the time axis on top of ``SystemPoint``:

  * ``Scenario``       — a frozen timeline of per-stream rate changes
                         plus a library of XR scenarios (idle, gaming,
                         passthrough, multi-user hand-off).
  * ``TraceSimulator`` — slices a scenario into constant-rate windows,
                         prices ALL windows x systems in one batched
                         columnar pass (``schedule.window_rollup``) and
                         folds them into peak/p99 power, deadline
                         misses, per-segment reload/wake energy and
                         battery-life estimates.
  * ``chrometrace``    — exports any simulation as Chrome tracing JSON
                         (``ph``/``ts``/``dur``/``pid``/``tid`` events)
                         so timelines open in Perfetto / chrome://tracing.

Steady state is the parity oracle: a constant-rate scenario reproduces
the ``SystemPoint`` report byte-identically (``tests/test_trace.py``).

A copy of ``repro.trace`` (numpy only), held byte for byte to it by
``tests/test_torch_trace.py``.
"""
from repro_torch.trace.chrometrace import chrome_trace, write_chrome_trace
from repro_torch.trace.scenario import SCENARIOS, Scenario, get_scenario
from repro_torch.trace.simulator import (BATTERY_VOLTAGE_V,
                                         DEFAULT_BATTERY_MAH, TraceReport,
                                         TraceSimulator, TraceTable, simulate)

__all__ = [
    "Scenario", "SCENARIOS", "get_scenario",
    "TraceSimulator", "TraceTable", "TraceReport", "simulate",
    "BATTERY_VOLTAGE_V", "DEFAULT_BATTERY_MAH",
    "chrome_trace", "write_chrome_trace",
]
