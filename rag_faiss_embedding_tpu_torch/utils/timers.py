"""Per-stage latency timers, and the port's spans.

``StageTimer`` is a copy of ``rag_faiss_embedding_tpu/utils/timers.py``
(the reference has no tracing at all, SURVEY.md §5), timed on
``time.monotonic_ns``. Used by the pipeline CLI and the API server (its
``/stats``); pairs with ``utils.profiling`` for device traces.

``span(name, **counts)`` marks a layer boundary of the program. A record
holds the name, ``t0_ns`` / ``t1_ns`` from ``time.monotonic_ns()`` (the
clock a device trace is mapped onto, so a span and a kernel compare
directly), its id, its parent's id, its request id (the root's id, shared
by every span below it) and the counts. Parent and request travel in a
``ContextVar``: a thread or task sees the spans its context carries.

No flag switches it. A root (a span opened with none active) records only
while a torch profiler records on the thread that opens it
(``torch.autograd._profiler_enabled()``, thread-local), and its children
record with it. Off, a span costs one ``ContextVar.get`` and, at a root,
the profiler check: no clock read, and the same shared object every time.
A span times what the code does already: it adds no synchronisation and
no ``record_function`` (a device-side annotation would count as busy time
in a trace of the card). Records stay in memory, at most ``CAP``; past it
they are counted in ``dropped()``. ``spans(t0_ns, t1_ns)`` reads them.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Dict, List, Optional

from torch.autograd import _profiler_enabled

CAP = 1_000_000

_ACTIVE: ContextVar[Optional["Span"]] = ContextVar("rag_span", default=None)
_IDS = itertools.count(1)


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.records: list = []  # (name, t0_ns, t1_ns, id, parent, request, counts)
        self.dropped = 0

    def keep(self, record: tuple) -> None:
        with self.lock:
            if len(self.records) < CAP:
                self.records.append(record)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class Span:
    """An open span; ``with`` enters it, ``add`` sets counts known only
    inside it. A span that does not record is ``_OFF``, which is falsy:
    guard a count that costs work with ``if s:``."""

    __slots__ = ("name", "id", "parent", "request", "counts", "t0", "_token")

    def __init__(self, name: str, parent: Optional["Span"], counts: dict):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self.counts = counts

    def __enter__(self) -> "Span":
        self._token = _ACTIVE.set(self)
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        _ACTIVE.reset(self._token)
        _RECORDER.keep((self.name, self.t0, t1, self.id, self.parent, self.request, self.counts))
        return False

    def add(self, **counts) -> None:
        self.counts.update(counts)

    def record(self, name: str, t0_ns: int, t1_ns: int, **counts) -> None:
        """Record a finished child span timed by the caller (a wait that
        began before the child's code ran)."""
        _RECORDER.keep((name, t0_ns, t1_ns, next(_IDS), self.id, self.request, counts))


class _Off:
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, **counts):
    """A span around a ``with`` block: a child of the active span, or a
    root while a torch profiler records on this thread; else ``_OFF``."""
    parent = _ACTIVE.get()
    if parent is None and not _profiler_enabled():
        return _OFF
    return Span(name, parent, counts)


def current() -> Optional[Span]:
    """The active span of this context, or None."""
    return _ACTIVE.get()


def spans(t0_ns: int = 0, t1_ns: Optional[int] = None) -> List[dict]:
    """The records that started in [t0_ns, t1_ns), in the order they were
    recorded (a span is recorded when it ends)."""
    with _RECORDER.lock:
        records = list(_RECORDER.records)
    return [{"name": n, "t0_ns": a, "t1_ns": b, "id": i, "parent": p, "request": r,
             "counts": c}
            for n, a, b, i, p, r, c in records
            if a >= t0_ns and (t1_ns is None or a < t1_ns)]


def dropped() -> int:
    """Records refused since the last ``clear`` because ``CAP`` were held."""
    return _RECORDER.dropped


def clear() -> None:
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.dropped = 0


class StageTimer:
    def __init__(self):
        self.stages: Dict[str, List[float]] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.stages.setdefault(name, []).append((time.monotonic_ns() - t0) / 1e9)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, times in self.stages.items():
            s = sorted(times)
            out[name] = {
                "count": len(s),
                "total_s": sum(s),
                "mean_s": sum(s) / len(s),
                "p50_s": s[len(s) // 2],
                "p99_s": s[min(len(s) - 1, int(len(s) * 0.99))],
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'mean ms':>12}{'p50 ms':>12}{'p99 ms':>12}"]
        for name, st in self.summary().items():
            lines.append(
                f"{name:<24}{st['count']:>8}{st['mean_s']*1e3:>12.2f}"
                f"{st['p50_s']*1e3:>12.2f}{st['p99_s']*1e3:>12.2f}"
            )
        return "\n".join(lines)
