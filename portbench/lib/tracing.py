"""A traced segment of a run: ``torch.profiler`` over a few steps or
requests, capture-checked, reduced to what the per-layer readers take.

The window is padded as ``chip_smoke.py``'s ``device_us`` pads it: the
profiler drops device events at a window's start, so ``PAD_FRONT`` spin
kernels run first and are waited for, and the traced work starts after
them inside a ``record_function`` range (``WINDOW_MARK``) that gives the
traced window on the trace's clock; ``PAD_BACK`` spins follow its end.
The capture is whole when the device operations in it number at least the
host's launch calls inside the range (``LAUNCH_APIS``, as ``_capture``
there counts them); a short capture is "not measured" and the caller
traces another segment.

``Summary`` holds the device operations of the window (kernels, copies,
fills), the busy time (the union of their intervals), and the idle time
cut by what the host was doing: the innermost profiler range open on the
host (per thread; the thread with most ranges over a gap names it), or
"python" where no range was open.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PAD_FRONT, PAD_BACK, PAD_CYCLES = 96, 4, 1_000_000
PAD_NAME = "spin_kernel"
WINDOW_MARK = "portbench_traced_window"
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
               "cudaMemsetAsync", "cudaMemcpyAsync", "cudaMemcpy")
IDLE_NO_RANGE = "python"


@dataclass
class Summary:
    units: int                          # steps or requests traced
    window_us: float
    busy_us: float
    ops: List[Tuple[str, float]]        # (name, device us), stream order
    idle_by_host: Dict[str, float] = field(default_factory=dict)   # us
    capture: Dict = field(default_factory=dict)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, us in self.ops:
            out[name] = out.get(name, 0.0) + us
        return out

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        """The device operations that took most time and the idle time by
        host activity, in seconds, at most ``n`` of each."""
        top = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v / 1e6] for k, v in top],
                "idle_gaps": [[k[:160], v / 1e6] for k, v in idle]}


class Tracer:
    """``start()`` before the first traced unit, ``stop(units)`` after the
    last one's results were waited for; ``stop`` returns a ``Summary`` or
    None when the capture fell short."""

    def __init__(self):
        self.prof = None
        self.mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PAD_FRONT):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        self.mark = record_function(WINDOW_MARK)
        self.mark.__enter__()

    def stop(self, units: int) -> Optional[Summary]:
        import torch
        torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        for _ in range(PAD_BACK):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = [_Event.of(e) for e in self.prof.events()]
        self.prof = self.mark = None
        return summarize(events, units)


@dataclass
class _Event:
    name: str
    start: float        # us, the trace's clock
    end: float
    device: bool
    thread: int

    @classmethod
    def of(cls, e) -> "_Event":
        from torch.autograd import DeviceType
        return cls(e.name, float(e.time_range.start), float(e.time_range.end),
                   e.device_type == DeviceType.CUDA, int(e.thread))


def summarize(events: List[_Event], units: int) -> Optional[Summary]:
    """Reduce one traced window's events; None if the capture is short."""
    marks = [e for e in events if e.name == WINDOW_MARK and not e.device]
    if len(marks) != 1:
        return None
    w0, w1 = marks[0].start, marks[0].end
    ops = sorted((e for e in events if e.device and e.name != WINDOW_MARK
                  and PAD_NAME not in e.name and w0 <= e.start <= w1),
                 key=lambda e: e.start)
    launched = sum(1 for e in events if not e.device and e.name in LAUNCH_APIS
                   and w0 <= e.start <= w1)
    capture = {"launch_calls": launched, "device_events": len(ops)}
    if len(ops) < launched or not ops:
        capture["short"] = True
        return None
    busy, gaps, cur = 0.0, [], w0
    for e in ops:
        s, t = max(e.start, cur), min(e.end, w1)
        if s > cur:
            gaps.append((cur, s))
        if t > s:
            busy += t - s
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    host = [e for e in events if not e.device and e.name != WINDOW_MARK
            and e.end > w0 and e.start < w1]
    return Summary(units, w1 - w0, busy, [(e.name, e.end - e.start) for e in ops],
                   idle_by_host(gaps, host), capture)


def _innermost(events: List[_Event]) -> List[Tuple[float, float, str]]:
    """One thread's nested ranges cut into segments, each named by the
    innermost range open over it."""
    segs: List[Tuple[float, float, str]] = []
    stack: List[_Event] = []
    cur = None
    for e in sorted(events, key=lambda e: (e.start, -e.end)):
        while stack and stack[-1].end <= e.start:
            top = stack.pop()
            if top.end > cur:
                segs.append((cur, top.end, top.name))
                cur = top.end
        if cur is None:
            cur = e.start
        if stack and e.start > cur:
            segs.append((cur, e.start, stack[-1].name))
        cur = max(cur, e.start)
        stack.append(e)
    while stack:
        top = stack.pop()
        if top.end > cur:
            segs.append((cur, top.end, top.name))
            cur = top.end
    return segs


def idle_by_host(gaps: List[Tuple[float, float]], host: List[_Event]
                 ) -> Dict[str, float]:
    """Idle microseconds by the host range open over them."""
    threads: Dict[int, List[_Event]] = {}
    for e in host:
        threads.setdefault(e.thread, []).append(e)
    segs = {t: _innermost(evs) for t, evs in threads.items()}
    starts = {t: [s[0] for s in ss] for t, ss in segs.items()}
    out: Dict[str, float] = {}
    for a, b in gaps:
        best: Dict[str, float] = {}
        for t, ss in segs.items():
            got: Dict[str, float] = {}
            i = max(0, bisect.bisect_right(starts[t], a) - 1)
            while i < len(ss) and ss[i][0] < b:
                ov = min(b, ss[i][1]) - max(a, ss[i][0])
                if ov > 0:
                    got[ss[i][2]] = got.get(ss[i][2], 0.0) + ov
                i += 1
            if sum(got.values()) > sum(best.values()):
                best = got
        rest = (b - a) - sum(best.values())
        if rest > 0:
            best[IDLE_NO_RANGE] = best.get(IDLE_NO_RANGE, 0.0) + rest
        for k, v in best.items():
            out[k] = out.get(k, 0.0) + v
    return out
