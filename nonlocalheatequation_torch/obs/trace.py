"""Bounded span tracer exporting Chrome trace-event JSON (Perfetto) — the
single-process subset of ``nonlocalheatequation_tpu/obs/trace.py``.

The ensemble engine opens the spans ``ensemble.chunk`` and
``ensemble.build`` (serve/ensemble.py).  :func:`span` is a no-op (one
attribute read) until :func:`set_tracer` installs a :class:`Tracer`; then
each span appends one complete ('X') event to the tracer's ring buffer,
which :meth:`Tracer.chrome_trace` returns as a loadable document.  Recording
never raises and reads only the host clock (injectable, for tests).  The
cross-process context, the wire format and ``merge_chrome_traces`` wait for
the serving slice.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

#: Default ring-buffer capacity (events).
DEFAULT_CAPACITY = 65536


class _NullSpan:
    """The shared no-op context manager the disabled path returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ('X') event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args

    def __enter__(self):
        try:
            self._t0 = self._tracer._clock()
        except Exception:  # noqa: BLE001 — observability never raises
            self._t0 = 0.0
        return self

    def __exit__(self, exc_type, exc, tb):
        args = self._args
        if exc_type is not None:
            args = {**args, "error": exc_type.__name__}
        self._tracer.complete(self._name, self._t0, cat=self._cat, tid=self._tid, **args)
        return False


class Tracer:
    """Thread-safe bounded span recorder with an injectable clock (seconds).
    ``spans_total`` counts every event recorded, evicted ones included."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.monotonic,
                 pid: int | None = None):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self.pid = os.getpid() if pid is None else int(pid)
        self.spans_total = 0

    def complete(self, name: str, t0: float, t1: float | None = None, cat: str = "",
                 tid: int = 0, **args) -> None:
        """One complete ('X') span from the caller's host-clock timestamps
        (``t1=None`` reads the tracer's clock once)."""
        try:
            if t1 is None:
                t1 = self._clock()
            ev = {"name": name, "cat": cat or "nlheat", "ph": "X", "ts": round(t0 * 1e6, 3),
                  "dur": round(max(0.0, t1 - t0) * 1e6, 3), "pid": self.pid, "tid": int(tid)}
            if args:
                ev["args"] = args
            with self._lock:
                self.events.append(ev)
                self.spans_total += 1
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def span(self, name: str, cat: str = "", tid: int = 0, **args) -> _Span:
        return _Span(self, name, cat, tid, args)

    def __len__(self) -> int:
        return len(self.events)

    def chrome_trace(self) -> dict:
        """The Perfetto-loadable document."""
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"pid": self.pid}}


_tracer: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _tracer


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install the process-global tracer (None disables); returns the
    previous one so callers can restore it."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def span(name: str, cat: str = "", **args):
    """A real span under the global tracer, the shared no-op otherwise."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return t.span(name, cat=cat, **args)
