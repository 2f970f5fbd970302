"""The traced run's profiler window and its reduction to facts.

:class:`Tracer` records one span of the measured window with torch.profiler
(host and device activities), inside a ``bench_window`` range opened after a
device synchronisation and closed after another, so the device work of the
span lies inside it.  :func:`reduce` turns the profiler's events into what
the per-layer readers take: the window's length, the device's busy time
(the union of kernel, copy and fill intervals), each kernel's intervals by
name, the host's ranges, and the breakdown (the device operations
that took most time, the longest idle gaps named by the innermost host range
open when each began).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Optional

import torch

WINDOW = "bench_window"


class Tracer:
    """``counters()`` (the port's launch counters) is read when the span
    starts and when it stops; ``launched`` holds the difference."""

    def __init__(self, device: torch.device, counters: Callable[[], dict]):
        self.device, self.counters = device, counters
        self.prof: Optional[torch.profiler.profile] = None
        self._range = None
        self._before: dict = {}
        self.events = None
        self.launched: dict = {}

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.__enter__()
        # one kernel through the fresh device tracing before the span opens
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize(self.device)
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self._before = self.counters()

    @property
    def running(self) -> bool:
        return self._range is not None

    def stop(self) -> None:
        if self._range is None:
            return
        torch.cuda.synchronize(self.device)
        after = self.counters()
        self.launched = {k: after[k] - self._before[k] for k in after}
        self._range.__exit__(None, None, None)
        self._range = None
        self.prof.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()


def reduce(events) -> dict:
    """Facts of a traced window from the profiler's raw events.  Device
    events are the kernels, copies and fills; the device-side copies of the
    host's ranges (which carry a host range's name) are left out."""
    window = None
    ranges, device = [], []
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((start, end, ev.name()))
        elif ev.name() == WINDOW:
            window = (start, end)
        elif end > start:
            ranges.append((start, end, ev.name()))
    host_names = {r[2] for r in ranges} | {WINDOW}
    device = [d for d in device if d[2] not in host_names]
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1)
    busy, gaps, cursor = 0, [], w0
    per_op: dict[str, float] = defaultdict(float)
    kernels: dict[str, list] = defaultdict(list)
    for s, e, name in device:
        per_op[name] += (e - s) / 1e9
        kernels[name].append((s, e))
        if e <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        busy += e - max(s, cursor)
        cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    ranges.sort()
    starts = [r[0] for r in ranges]

    def host_at(t: int) -> str:
        """The innermost host range open at ``t`` (the latest started that
        has not ended)."""
        i = bisect.bisect_right(starts, t)
        for _, e, name in reversed(ranges[max(0, i - 4000):i]):
            if e > t:
                return name
        return WINDOW

    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": kernels,
        "ranges": ranges,
        "breakdown": {
            "device_ops": sorted(([n, t] for n, t in per_op.items()),
                                 key=lambda x: x[1], reverse=True)[:10],
            "idle_gaps": [[host_at(s), (e - s) / 1e9] for s, e in longest],
        },
    }


def kernel_times(facts: dict, fragment: str) -> list[float]:
    """Seconds of each launch of the kernels whose name holds ``fragment``."""
    return [(e - s) / 1e9 for name, ivs in facts["kernels"].items() if fragment in name
            for s, e in ivs]


def range_seconds(facts: dict, name: str) -> list[float]:
    """Seconds of each host range ``name`` in the window."""
    return [(e - s) / 1e9 for s, e, n in facts["ranges"] if n == name]


# the port's kernels by a fragment of their names, and their launch counters
KERNELS = {"span_decode_kernel": ("span_decode",),
           "fused_forward_kernel": ("fused_forward", "fused_forward_bf16")}


def check_launches(facts: dict, launched: dict) -> None:
    """The trace holds the launches of K1 and of K2 that the port's counters
    counted over the traced span, none more and at most 1% fewer (the
    profiler has dropped a single kernel of 200 graph replays); raises
    otherwise."""
    for fragment, counters in KERNELS.items():
        traced = len(kernel_times(facts, fragment))
        counted = sum(launched[c] for c in counters)
        if traced > counted or counted - traced > counted // 100:
            raise RuntimeError(f"the trace holds {traced} launches of {fragment}, the "
                               f"port counted {counted}: the trace is incomplete")
