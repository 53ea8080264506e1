"""Host spans from the benchmark's own wrappers, and the device's trace.

``Spans`` wraps a layer's entry point on an instance the cell built (never
inside the program) and records (name, start, end, meta) on the host clock,
in memory. ``DeviceTrace`` runs ``torch.profiler`` over the same window and
keeps, from the raw Kineto events, every device operation (kernel, copy,
set) with its card, start and end. Frozen from ``chip_smoke.py``:
``device_busy_ms`` (``chip_smoke.py:702``, the union of device intervals)
as ``busy_ns``.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Spans:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records = defaultdict(list)  # name -> [(t0_ns, t1_ns, meta)]

    def wrap(self, obj, method: str, name: str, meta=None) -> None:
        """Record a span around ``obj.method`` (an instance attribute, so
        the class and other instances are untouched). ``meta(args, kwargs,
        result)`` gives the span's numbers."""
        if not self.enabled:
            return
        fn = getattr(obj, method)
        records = self.records[name]

        def wrapped(*args, **kwargs):
            t0 = time.monotonic_ns()
            out = fn(*args, **kwargs)
            t1 = time.monotonic_ns()
            records.append((t0, t1, meta(args, kwargs, out) if meta else None))
            return out

        setattr(obj, method, wrapped)

    def between(self, t0: int, t1: int) -> dict:
        """The spans that started inside [t0, t1)."""
        return {n: [s for s in v if t0 <= s[0] < t1] for n, v in self.records.items()}


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceTrace:
    """``torch.profiler`` over a window; ``events`` are (name, card, start_ns,
    end_ns) on the host's ``monotonic_ns`` clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events = []
        self.prof = None

    @contextmanager
    def window(self):
        if not self.enabled:
            yield self
            return
        from torch.profiler import ProfilerActivity, profile

        # device activity only: host ops would add millions of events
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        wall, mono = time.time_ns(), time.monotonic_ns()
        try:
            yield self
        finally:
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            self.prof.stop()
            self._collect(wall, mono)

    def _collect(self, wall: int, mono: int) -> None:
        from torch.autograd import DeviceType

        result = self.prof.profiler.kineto_results
        # Kineto's clock: the wall clock on the machines seen so far; where
        # its trace start lies nearer the monotonic clock, take that
        start = result.trace_start_ns()
        shift = wall - mono if abs(start - wall) < abs(start - mono) else 0
        for e in result.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = e.start_ns() - shift
            self.events.append((e.name(), e.device_index(), s, s + e.duration_ns()))
        self.prof = None

    def crop(self, t0: int, t1: int) -> list:
        return [(n, c, max(a, t0), min(b, t1)) for n, c, a, b in self.events if b > t0 and a < t1]
