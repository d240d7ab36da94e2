"""Crash flight recorder: a bounded black box with postmortem dumps — the
port's copy of ``nonlocalheatequation_tpu/obs/flightrec.py``.

The reference debugs a dead locality with whatever HPX printed before the
crash.  The flight recorder keeps the evidence: a per-process RING of the
most recent discrete events (the same stream the ``NLHEAT_EVENT_LOG`` JSONL
carries — retries, quarantines, breaker transitions, retired chunks), plus
bound providers for the live metrics registry and the in-flight ledger,
dumped to a timestamped postmortem file when something dies:

* **typed ServeError quarantine** — the serving pipeline dumps when a
  poison case completes exceptionally (serve/server.py ``_quarantine``);
* **breaker open** — the pipeline dumps on a closed -> open transition;
* **SIGTERM** — :func:`install_sigterm` chains a dump in front of the
  previous handler (a drained or killed CLI still leaves its black box).

Contract (the obs/ discipline): recording is bounded (ring + lifetime
count), never raises, and costs one attribute read when no recorder is
installed (emitters hold the module global and skip one ``if``).  A dump
flushes any registered sinks first (the EventLog registers its ``flush``:
postmortems are never torn mid-line), then writes atomically via
tmp+rename.  The dump format and its field names are the JAX module's.

Enable with ``NLHEAT_FLIGHT_DIR=DIR`` (the CLIs' ``--flight-dir``), or
construct one explicitly.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
from collections import deque

#: Env var naming the postmortem directory (scrubbed by tests/conftest.py
#: like NLHEAT_EVENT_LOG: a leaked developer setting must not make the
#: suite write files).
FLIGHT_DIR_ENV = "NLHEAT_FLIGHT_DIR"

#: Default ring capacity (events).  The black box holds the RECENT story,
#: not the life of the process; that is the EventLog's job.
DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Bounded event ring + postmortem dumper.  Never raises.

    ``record`` appends one stamped event (per-process ``seq``
    lifetime-exact, wall ``t``); ``bind`` attaches the live registry and an
    in-flight-ledger callable; ``add_flush`` registers a sink to flush
    before any dump (the EventLog); ``dump`` writes the black box — last-N
    events, registry snapshot, in-flight ledger, the trigger — to
    ``dir/postmortem-<stamp>-pid<pid>[-r<replica>]-<n>.json``."""

    def __init__(self, dir_path: str, capacity: int = DEFAULT_CAPACITY,
                 clock=time.time, replica=None):
        self.dir = str(dir_path)
        os.makedirs(self.dir, exist_ok=True)
        self.events: deque = deque(maxlen=max(1, int(capacity)))
        self.events_total = 0  # lifetime-exact through eviction
        self.dumps = 0
        self._clock = clock
        # RLock, not Lock: the SIGTERM handler (install_sigterm) runs on the
        # MAIN thread and calls record()/dump() — if the signal lands while
        # that thread is inside a lock-held section, a plain Lock would
        # deadlock the shutdown path the black box exists to cover
        self._lock = threading.RLock()
        self.pid = os.getpid()
        if replica is None:
            replica = os.environ.get("NLHEAT_REPLICA_ID")
        self.replica = int(replica) if replica is not None \
            and str(replica).isdigit() else replica
        self._registry = None
        self._inflight = None  # zero-arg callable -> ledger list
        self._flushes: list = []

    # -- wiring -------------------------------------------------------------
    def bind(self, registry=None, inflight=None) -> None:
        """Attach the live telemetry the postmortem snapshots: a
        MetricsRegistry (or a zero-arg callable returning one) and an
        in-flight-ledger callable.  Later binds win (one recorder per
        process, one serving pipeline per worker)."""
        if registry is not None:
            self._registry = registry
        if inflight is not None:
            self._inflight = inflight

    def add_flush(self, fn) -> None:
        """Register a sink flushed before every dump (EventLog.flush: a
        postmortem must never race a half-written JSONL line)."""
        if fn is not None and fn not in self._flushes:
            self._flushes.append(fn)

    # -- recording ----------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event to the ring.  Never raises."""
        try:
            with self._lock:
                seq = self.events_total
                self.events_total += 1
                ev = {"seq": seq, "t": self._clock(), "kind": kind}
                ev.update(fields)
                self.events.append(ev)
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def __len__(self) -> int:
        return len(self.events)

    # -- the dump -----------------------------------------------------------
    def snapshot(self, reason: str, **extra) -> dict:
        """The postmortem document (dump() writes it; tests read it)."""
        with self._lock:
            events = [dict(e) for e in self.events]
        doc = {
            "postmortem": reason,
            "t": self._clock(),
            "pid": self.pid,
            "events": events,
            "events_total": self.events_total,
        }
        if self.replica is not None:
            doc["replica"] = self.replica
        if extra:
            doc.update(extra)
        reg = self._registry
        try:
            if callable(reg):
                reg = reg()
            if reg is not None:
                doc["registry"] = reg.snapshot()
        except Exception:  # noqa: BLE001
            pass
        try:
            if self._inflight is not None:
                doc["inflight"] = self._inflight()
        except Exception:  # noqa: BLE001
            pass
        return doc

    def dump(self, reason: str, **extra) -> str | None:
        """Write one postmortem file; returns its path (None on failure,
        loudly).  Flushes registered sinks first so the postmortem and the
        JSONL event log agree on what happened."""
        try:
            for fn in self._flushes:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    pass
            doc = self.snapshot(reason, **extra)
            with self._lock:
                n = self.dumps
                self.dumps += 1
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(doc["t"]))
            rep = f"-r{self.replica}" if self.replica is not None else ""
            path = os.path.join(self.dir, f"postmortem-{stamp}-pid{self.pid}{rep}-{n}.json")
            tmp = f"{path}.tmp.{socket.gethostname()}.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
            return path
        except Exception as e:  # noqa: BLE001
            try:
                print(f"[obs] flight-recorder dump ({reason}) failed: {e!r}", file=sys.stderr)
            except Exception:  # noqa: BLE001
                pass
            return None

    @classmethod
    def from_env(cls, environ=os.environ) -> "FlightRecorder | None":
        """The opt-in hook: a recorder when ``NLHEAT_FLIGHT_DIR`` is set and
        creatable, else None (loud on an unusable dir, like
        EventLog.from_env)."""
        path = environ.get(FLIGHT_DIR_ENV)
        if not path:
            return None
        try:
            return cls(path)
        except OSError as e:
            print(f"[obs] {FLIGHT_DIR_ENV}={path!r} cannot be used ({e}); flight recorder "
                  "disabled", file=sys.stderr)
            return None


_recorder: FlightRecorder | None = None


def get_recorder() -> FlightRecorder | None:
    return _recorder


def set_recorder(rec: FlightRecorder | None) -> FlightRecorder | None:
    """Install the process-global recorder (None disables); returns the
    previous one so callers can restore it."""
    global _recorder
    prev = _recorder
    _recorder = rec
    return prev


def record(kind: str, **fields) -> None:
    """Module-level tap: record into the global recorder if installed (one
    attribute read when off — the obs/ disabled-path shape)."""
    r = _recorder
    if r is not None:
        r.record(kind, **fields)


def install_sigterm(rec: FlightRecorder) -> None:
    """Dump a postmortem on SIGTERM, then chain to the previous disposition —
    a terminated server still leaves its black box.  A previously IGNORED
    signal (SIG_IGN) stays ignored after the dump: arming the recorder must
    never turn a signal the process was configured to survive into death.
    Main thread only (signal API); a failed install is swallowed
    (observability never kills the run)."""
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            rec.record("sigterm")
            rec.dump("sigterm")
            if prev is signal.SIG_IGN:
                return  # the process was configured to ignore SIGTERM
            if callable(prev) and prev is not signal.SIG_DFL:
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError, RuntimeError):
        pass  # not the main thread / restricted env: no handler
