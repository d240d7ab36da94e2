"""Bounded span tracer exporting Chrome trace-event JSON (Perfetto) — the
port's copy of ``nonlocalheatequation_tpu/obs/trace.py``.

The reference's only timeline is wall-clock CSV around ``do_work``
(src/2d_nonlocal_distributed.cpp:1390-1395); the port's device-side
timeline is the ``torch.profiler`` capture (utils/profiling.py).  This
module adds the HOST-side timeline between them: named spans around the
serving pipeline's stages (window close, build/stage/dispatch,
fence/fetch, retries, bisection, breaker transitions, fallback routes —
serve/server.py), the ensemble engine's chunk lifecycle (``ensemble.*``),
the solvers' step batches, checkpoint save/load and the rebalances,
exported in the Chrome trace-event format so one file loads in
ui.perfetto.dev next to the profiler capture (the CLIs' ``--trace DIR``
captures both into the same directory).  The span names are the JAX
package's, so a merged timeline reads the same from either package.

Hard rules:

* **never raises** — every record path swallows its own failures;
* **never fences** — timestamps are host clock reads the instrumented
  code mostly already makes; fetch spans reuse the fences the pipeline
  performs anyway (``Tracer.complete`` takes the CALLER's timestamps,
  so tracing adds no clock reads on timed paths);
* **bounded** — a ring buffer of ``capacity`` events (oldest evicted),
  with a lifetime-exact ``spans_total``;
* **zero-cost when off** — the module-level :func:`span`/:func:`instant`
  helpers are no-ops (an attribute read, and for :func:`span` a
  ``sys.modules`` lookup and the profiler's flag) until :func:`set_tracer`
  installs a tracer or a ``torch.profiler`` capture starts.

While a ``torch.profiler`` capture records in this process (the CLIs'
``--profile DIR``, a benchmark's traced window), every span, with or
without a tracer, also records a host range named ``nlheat.<span name>``
for its extent: the span then lands in the profiler's own record, on its
clock, beside the operators and the card's kernels and copies.  The range
is a function-scope record (``torch._C._profiler._RecordFunctionFast``, a
``cpu_op`` in the record), not a ``record_function`` user annotation: the
profiler gives each user annotation a ``gpu_user_annotation`` twin on the
card's timeline that spans the device work launched inside it, and a
reader that tells device events apart by name alone (portbench/devtrace.py
on torch 2.11) counts such a twin as a kernel.  Torch is reached through
``sys.modules`` only: a process that never imported it records no capture.

The clock is injectable: tests drive a virtual clock and assert golden
span sequences deterministically (tests/test_torch_obs.py).

Cross-process identity: :class:`TraceContext` is a compact request
identity (a trace id, the parent span, the case seq) with a tuple wire
form and the ``X-NLHEAT-Trace`` header form; :func:`set_context`
installs it on a thread so every span a tracer records there carries
``args.trace``.  :meth:`Tracer.flow` emits Chrome *flow* events
(``s``/``t``/``f``) tying spans across processes, and
:func:`merge_chrome_traces` aligns per-process monotonic clocks (the
``clock_sync`` pair each tracer captures at construction) into ONE
Perfetto-loadable timeline.  No context is ever read unless a tracer is
emitting.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from collections import deque

#: Default ring-buffer capacity (events).  At ~6 events per served chunk
#: this holds hours of serving; the cap is the point — a long-lived
#: server must not grow host memory with its request count.
DEFAULT_CAPACITY = 65536


class _NullSpan:
    """The shared no-op context manager the disabled path returns."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

#: Prefix of a span's range in a ``torch.profiler`` capture.
PROFILER_PREFIX = "nlheat."


def _profiler_range(name: str):
    """A host range named ``nlheat.<name>`` while a ``torch.profiler``
    capture records in this process, else None."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch._C._autograd._profiler_enabled():
            return None
        return torch._C._profiler._RecordFunctionFast(PROFILER_PREFIX + name)
    except Exception:  # noqa: BLE001 — observability never raises
        return None


class TraceContext:
    """The compact cross-process request identity.

    ``trace_id`` is the request's identity (16 hex chars — also the Chrome
    flow-event ``id``); ``span_id`` names the parent span that minted or
    forwarded it; ``request`` is the case seq when known.  Wire forms:
    :meth:`to_wire` (a plain tuple) and :meth:`to_header`/:meth:`from_header`
    (the ``X-NLHEAT-Trace`` HTTP header, ``trace_id[:span_id[:request]]``).
    """

    __slots__ = ("trace_id", "span_id", "request")

    def __init__(self, trace_id: str, span_id: str | None = None,
                 request: int | None = None):
        self.trace_id = str(trace_id)
        self.span_id = span_id
        self.request = request

    @classmethod
    def mint(cls, span_id: str | None = None,
             request: int | None = None) -> "TraceContext":
        """A fresh random identity (the ingress / first-touch path)."""
        return cls(os.urandom(8).hex(), span_id, request)

    def child(self, span_id: str) -> "TraceContext":
        """The same trace continuing under a new parent span."""
        return TraceContext(self.trace_id, span_id, self.request)

    # -- wire forms ---------------------------------------------------------
    def to_wire(self) -> tuple:
        return (self.trace_id, self.span_id, self.request)

    @classmethod
    def from_wire(cls, wire) -> "TraceContext | None":
        """Tolerant decode (a malformed frame field must cost the trace,
        never the case): None/garbage -> None."""
        try:
            if not wire:
                return None
            tid = str(wire[0])
            sid = wire[1] if len(wire) > 1 and wire[1] is not None else None
            req = int(wire[2]) if len(wire) > 2 and wire[2] is not None \
                else None
            return cls(tid, None if sid is None else str(sid), req)
        except Exception:  # noqa: BLE001 — observability never raises
            return None

    def to_header(self) -> str:
        parts = [self.trace_id]
        if self.span_id is not None or self.request is not None:
            parts.append(self.span_id or "")
        if self.request is not None:
            parts.append(str(self.request))
        return ":".join(parts)

    @classmethod
    def from_header(cls, header: str) -> "TraceContext | None":
        try:
            parts = [p.strip() for p in str(header).split(":")]
            if not parts or not parts[0]:
                return None
            sid = parts[1] if len(parts) > 1 and parts[1] else None
            req = int(parts[2]) if len(parts) > 2 and parts[2] else None
            return cls(parts[0], sid, req)
        except Exception:  # noqa: BLE001
            return None

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, span_id={self.span_id!r}, "
                f"request={self.request!r})")


#: Thread-local current trace context.  Emitters never read it unless a
#: tracer is actually recording (the disabled path stays one attribute
#: read); when set, every event a tracer emits on this thread carries
#: ``args.trace`` (+ ``args.req``) so the ServePipeline and ensemble spans
#: nest under the originating request with ZERO changes at their call
#: sites.
_context = threading.local()


def current_context() -> TraceContext | None:
    return getattr(_context, "value", None)


def set_context(ctx: TraceContext | None) -> TraceContext | None:
    """Install the thread's current trace context (None clears); returns
    the previous one so callers can restore it."""
    prev = getattr(_context, "value", None)
    _context.value = ctx
    return prev

#: Explicit "tracing OFF" sentinel for constructors whose ``tracer=None``
#: means "inherit the process-global tracer" (serve/server.py
#: ServePipeline): pass TRACE_OFF to force the untraced path even when a
#: global tracer is installed — the A/B baseline in serve_traced_ab
#: must never silently trace both arms.
TRACE_OFF = _NullSpan()


class _Span:
    """Context manager recording one complete ('X') event on exit (with a
    tracer) and holding the profiler's range ``rng`` open for its extent
    (while a capture records)."""

    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0", "_range")

    def __init__(self, tracer, name, cat, tid, args, rng=None):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args
        self._range = rng

    def __enter__(self):
        if self._range is not None:
            try:
                self._range.__enter__()
            except Exception:  # noqa: BLE001 — observability never raises
                self._range = None
        if self._tracer is not None:
            try:
                self._t0 = self._tracer._clock()
            except Exception:  # noqa: BLE001
                self._t0 = 0.0
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tracer is not None:
            args = self._args
            if exc_type is not None:
                args = {**args, "error": exc_type.__name__}
            self._tracer.complete(self._name, self._t0, cat=self._cat,
                                  tid=self._tid, **args)
        if self._range is not None:
            try:
                self._range.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        return False


class Tracer:
    """Thread-safe bounded span recorder with an injectable clock.

    ``complete``/``instant``/``counter`` append one Chrome trace event
    each; ``span`` is the context-manager form.  ``chrome_trace`` returns
    the loadable document; ``write`` saves it (never raises).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.monotonic, pid: int | None = None,
                 label: str | None = None, replica=None,
                 clock_sync: dict | None = None):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self.pid = os.getpid() if pid is None else int(pid)
        self.spans_total = 0  # lifetime-exact (evictions included)
        #: merge identity: a display label ("replica 3"), the replica id
        #: (defaults to NLHEAT_REPLICA_ID — obs/export.py REPLICA_ID_ENV),
        #: and the (monotonic, wall) clock pair captured ONCE here so
        #: merge_chrome_traces can align this process's monotonic-epoch
        #: timestamps with every other process's.  ``clock_sync`` is
        #: injectable for deterministic merge tests.
        self.label = label
        if replica is None:
            replica = os.environ.get("NLHEAT_REPLICA_ID")
        self.replica = int(replica) if replica is not None \
            and str(replica).isdigit() else replica
        if clock_sync is None:
            try:
                clock_sync = {"monotonic": time.monotonic(),
                              "wall": time.time()}
            except Exception:  # noqa: BLE001 — observability never raises
                clock_sync = None
        self.clock_sync = clock_sync

    def _emit(self, ev: dict) -> None:
        try:
            # stamp the thread's current TraceContext:
            # only ever read while a tracer is RECORDING, so the
            # disabled path never touches it; explicit per-event args
            # of the same name win (setdefault).  Counter ('C') events
            # are exempt — every args key of a counter is a PLOTTED
            # SERIES in Perfetto, and a stamp would graft bogus
            # trace/req tracks onto e.g. the inflight counter
            ctx = getattr(_context, "value", None)
            if ctx is not None and ev.get("ph") != "C":
                args = ev.setdefault("args", {})
                args.setdefault("trace", ctx.trace_id)
                if ctx.request is not None:
                    args.setdefault("req", ctx.request)
            with self._lock:
                self.events.append(ev)
                self.spans_total += 1
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def complete(self, name: str, t0: float, t1: float | None = None,
                 cat: str = "", tid: int = 0, **args) -> None:
        """One complete ('X') span from the CALLER's host-clock
        timestamps in seconds — no extra clock reads on timed paths
        (``t1=None`` reads the tracer clock once)."""
        try:
            if t1 is None:
                t1 = self._clock()
            ev = {"name": name, "cat": cat or "nlheat", "ph": "X",
                  "ts": round(t0 * 1e6, 3),
                  "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                  "pid": self.pid, "tid": int(tid)}
            if args:
                ev["args"] = args
            self._emit(ev)
        except Exception:  # noqa: BLE001
            pass

    def instant(self, name: str, ts: float | None = None, cat: str = "",
                tid: int = 0, **args) -> None:
        """One instant ('i') event (retry, bisect, breaker move...)."""
        try:
            if ts is None:
                ts = self._clock()
            ev = {"name": name, "cat": cat or "nlheat", "ph": "i", "s": "t",
                  "ts": round(ts * 1e6, 3), "pid": self.pid, "tid": int(tid)}
            if args:
                ev["args"] = args
            self._emit(ev)
        except Exception:  # noqa: BLE001
            pass

    def counter(self, name: str, ts: float | None = None, tid: int = 0,
                **values) -> None:
        """One counter ('C') sample — Perfetto renders these as tracks
        (the pipeline samples chunks-in-flight here)."""
        try:
            if ts is None:
                ts = self._clock()
            self._emit({"name": name, "cat": "nlheat", "ph": "C",
                        "ts": round(ts * 1e6, 3), "pid": self.pid,
                        "tid": int(tid), "args": values})
        except Exception:  # noqa: BLE001
            pass

    _FLOW_PH = {"start": "s", "step": "t", "finish": "f"}

    def flow(self, name: str, phase: str, flow_id, ts: float | None = None,
             cat: str = "flow", tid: int = 0, **args) -> None:
        """One Chrome flow event tying spans across pids: ``phase`` is
        "start", "step", or "finish" (the chunk retire — bound to its
        ENCLOSING slice via ``bp: "e"``); ``flow_id`` is the request's
        trace_id.  Perfetto draws one arrow chain per id across the merged
        timeline."""
        try:
            ph = self._FLOW_PH[phase]
            if ts is None:
                ts = self._clock()
            ev = {"name": name, "cat": cat or "flow", "ph": ph,
                  "id": str(flow_id), "ts": round(ts * 1e6, 3),
                  "pid": self.pid, "tid": int(tid)}
            if ph == "f":
                ev["bp"] = "e"
            if args:
                ev["args"] = args
            self._emit(ev)
        except Exception:  # noqa: BLE001
            pass

    def span(self, name: str, cat: str = "", tid: int = 0, **args) -> _Span:
        return _Span(self, name, cat, tid, args, _profiler_range(name))

    def __len__(self) -> int:
        return len(self.events)

    def chrome_trace(self) -> dict:
        """The Perfetto-loadable document.  ``metadata`` carries the
        merge identity (clock_sync/pid/replica/label) — extra top-level
        keys are legal in the Chrome trace format and ignored by
        Perfetto; :func:`merge_chrome_traces` reads them."""
        with self._lock:
            events = list(self.events)
        meta = {"pid": self.pid}
        if self.clock_sync is not None:
            meta["clock_sync"] = dict(self.clock_sync)
        if self.replica is not None:
            meta["replica"] = self.replica
        if self.label is not None:
            meta["label"] = self.label
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": meta}

    def write(self, path: str) -> bool:
        """Save :meth:`chrome_trace` to ``path``.  Never raises (a trace
        that cannot be written must not kill the solve it observed);
        returns False and prints to stderr on failure.  One shared
        atomic-write body (:func:`write_chrome_trace`) serves both this
        and the merged-timeline writers."""
        return write_chrome_trace(self.chrome_trace(), path)


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
    """Module-level span helper: a real span under the global tracer, the
    profiler's range alone while a capture records with no tracer, the
    shared no-op context otherwise (the zero-cost disabled path)."""
    t = _tracer
    if t is not None:
        return t.span(name, cat=cat, **args)
    rng = _profiler_range(name)
    if rng is None:
        return NULL_SPAN
    return _Span(None, name, cat, 0, args, rng)


def instant(name: str, cat: str = "", **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, cat=cat, **args)


def merge_chrome_traces(docs) -> dict:
    """Merge per-process Chrome trace documents into ONE Perfetto
    timeline.

    Each input doc is a :meth:`Tracer.chrome_trace` (or any Chrome
    trace-event dict).  Clock alignment: a doc whose ``metadata``
    carries a ``clock_sync`` pair ``{monotonic, wall}`` — the pair each
    tracer captured at construction — has its monotonic-epoch timestamps shifted onto the shared
    wall clock (``ts + (wall - monotonic)``); docs without a pair pass
    through unshifted.  The merged timeline is re-based so the earliest
    event sits at t=0 (Perfetto renders relative time anyway; small
    numbers keep the JSON compact).

    Process identity: a doc with ``metadata.replica`` is re-pid'd to
    its replica id (so pid = replica in the merged view, matching the
    EventLog merge keys); a ``metadata.label`` becomes the
    Perfetto process name via an ``M``-phase ``process_name`` record.
    Flow events (``s``/``t``/``f`` sharing one trace id) survive
    verbatim, which is what ties one request's spans across pids.
    """
    merged: list = []
    names: list = []
    offsets: list = []
    seen_pids: set = set()
    for doc in docs:
        if not doc:
            continue
        meta = doc.get("metadata") or {}
        sync = meta.get("clock_sync") or {}
        try:
            off_us = (float(sync["wall"]) - float(sync["monotonic"])) * 1e6
        except (KeyError, TypeError, ValueError):
            off_us = 0.0
        replica = meta.get("replica")
        pid = None
        if replica is not None and str(replica).lstrip("-").isdigit():
            pid = int(replica)
        events = doc.get("traceEvents") or []
        label = meta.get("label")
        offsets.append((events, off_us, pid))
        if label is not None:
            name_pid = pid
            if name_pid is None:
                name_pid = meta.get("pid")
                if name_pid is None and events:
                    name_pid = events[0].get("pid")
            if name_pid is not None and name_pid not in seen_pids:
                seen_pids.add(name_pid)
                names.append({"name": "process_name", "ph": "M",
                              "pid": int(name_pid), "tid": 0,
                              "args": {"name": str(label)}})
    t0 = None
    for events, off_us, _pid in offsets:
        for ev in events:
            ts = ev.get("ts")
            if isinstance(ts, (int, float)):
                t = ts + off_us
                t0 = t if t0 is None else min(t0, t)
    t0 = t0 or 0.0
    for events, off_us, pid in offsets:
        for ev in events:
            ev = dict(ev)
            ts = ev.get("ts")
            if isinstance(ts, (int, float)):
                ev["ts"] = round(ts + off_us - t0, 3)
            if pid is not None:
                if ev.get("ph") == "M":
                    continue  # per-doc name records: the merge re-names
                ev["pid"] = pid
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("ts") or 0.0))
    return {"traceEvents": names + merged, "displayTimeUnit": "ms"}


def write_chrome_trace(doc: dict, path: str) -> bool:
    """Atomically save a Chrome trace document (a tracer's or a merged
    timeline).  tmp + rename, hostname+pid+id disambiguated (the
    utils/checkpoint.atomic_file discipline): concurrent writers —
    ranks sharing a filesystem, threads of one process —
    each land a COMPLETE document; a reader can never observe
    interleaved or truncated JSON that Perfetto rejects.  ``default=
    str``: one exotic span arg (a numpy scalar, a Path) must degrade to
    its repr, not discard the whole artifact.  Never raises; False and
    a stderr line on failure."""
    try:
        tmp = (f"{path}.tmp.{socket.gethostname()}"
               f".{os.getpid()}.{id(doc)}")
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return True
    except Exception as e:  # noqa: BLE001
        try:
            print(f"[obs] merged trace write to {path!r} failed: {e!r}",
                  file=sys.stderr)
        except Exception:  # noqa: BLE001
            pass
        return False
