"""The measured window of a run, then its traced segment.

A driver calls ``start()`` when set-up is over (every shape warmed up;
set-up's garbage is collected then) and ``tick(items)`` after each unit
of work (a training step, a request) has finished and been waited for. The window closes at the first tick at least
``seconds`` after ``start``: its rate is all the items of the units that
finished in it over all of its time. With tracing on, the next
``trace_units`` units run under ``tracing.Tracer`` (again, up to
``ATTEMPTS`` segments, where a capture falls short); they are not part of
the window. ``tick`` returns True once the run is done.
"""
from __future__ import annotations

import gc
import time
from typing import Optional

from portbench.lib.tracing import Summary, Tracer

ATTEMPTS = 3


class Window:
    def __init__(self, seconds: float, trace: bool, trace_units: int):
        self.seconds = seconds
        self.trace = trace
        self.trace_units = trace_units
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.units = 0
        self.items = 0
        self.summary: Optional[Summary] = None
        self.attempts = 0
        self._tracer: Optional[Tracer] = None
        self._traced = 0
        self.done = False

    def start(self) -> None:
        gc.collect()
        self.t0 = time.perf_counter()

    @property
    def open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0

    def tick(self, items: int) -> bool:
        now = time.perf_counter()
        if self.done:
            return True
        if self.t1 is None:
            self.units += 1
            self.items += items
            if now - self.t0 >= self.seconds:
                self.t1 = now
                if not self.trace:
                    self.done = True
                else:
                    self._begin_trace()
            return self.done
        self._traced += 1
        if self._traced >= self.trace_units:
            self.summary = self._tracer.stop(self._traced)
            if self.summary is None and self.attempts < ATTEMPTS:
                self._begin_trace()
            else:
                self.done = True
        return self.done

    def _begin_trace(self) -> None:
        self.attempts += 1
        self._traced = 0
        self._tracer = Tracer()
        self._tracer.start()
