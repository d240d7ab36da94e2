"""Exporters: a scrape endpoint and a JSONL event log — the port's copy of
``nonlocalheatequation_tpu/obs/export.py``.

The registry (obs/metrics.py) and tracer (obs/trace.py) hold telemetry
in process; this module moves it OUT:

* :func:`serve_metrics` — an opt-in stdlib-HTTP endpoint (the CLIs'
  ``--metrics-port``) answering ``/metrics`` with the Prometheus text
  exposition and ``/metrics.json`` with the one-line JSON snapshot, on
  127.0.0.1 only (telemetry, not an API; a scraper runs on the host).
  The registry argument may be a callable so the endpoint follows a
  live object — the serve CLIs bind it to the running pipeline's
  registry, which is ``ServeReport``'s own backing store, so a scrape
  mid-run and the final ``metrics_json()`` dump agree by construction.
* :class:`EventLog` — an append-only JSONL stream of discrete events
  (quarantines, breaker transitions, fallback routes, retired chunks),
  enabled by ``NLHEAT_EVENT_LOG=PATH``.  Disk-backed, so memory stays
  bounded no matter how long the server lives.

Both obey the observability contract: never raise past construction,
never fence, zero cost when off (``EventLog.from_env`` returns None
when the env var is unset; emitters hold that None and skip one ``if``).
"""

from __future__ import annotations

import heapq
import json
import os
import sys
import threading
import time

#: Env var naming the JSONL event-log path (scrubbed by tests/conftest.py
#: — a leaked developer setting must not make the suite write files).
EVENT_LOG_ENV = "NLHEAT_EVENT_LOG"

#: Env var carrying the replica id a fleet of worker processes assigns each
#: worker; EventLog stamps it (with the pid) on every line so N replicas
#: appending to one JSONL path — or N per-replica files concatenated later —
#: merge unambiguously.
REPLICA_ID_ENV = "NLHEAT_REPLICA_ID"


class EventLog:
    """Append-only JSONL event stream.  ``emit`` never raises.

    Every line carries ``pid`` and (when the process is a fleet worker,
    ``NLHEAT_REPLICA_ID``) ``replica`` — the merge keys for multi-replica
    streams — plus ``seq`` (a per-process lifetime-exact monotonic
    sequence number: interleaved multi-replica logs are totally
    orderable WITHIN each process after the fact) and ``t`` (wall clock, the cross-process merge hint
    :func:`merge_event_streams` heap-merges on).  Explicit event fields
    of the same name win."""

    def __init__(self, path: str, replica: str | int | None = None,
                 clock=time.time):
        self.path = path
        self._lock = threading.Lock()
        self._clock = clock
        self._seq = 0  # lifetime-exact, per-process
        if replica is None:
            replica = os.environ.get(REPLICA_ID_ENV)
        self._stamp = {"pid": os.getpid()}
        if replica is not None:
            self._stamp["replica"] = int(replica) \
                if str(replica).isdigit() else replica
        # line-buffered append: events from a crashed run survive
        self._f = open(path, "a", buffering=1)

    def emit(self, **event) -> None:
        try:
            with self._lock:
                seq = self._seq
                self._seq += 1
                line = json.dumps(
                    {**self._stamp, "seq": seq,
                     "t": round(self._clock(), 6), **event}, default=str)
                self._f.write(line + "\n")
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def flush(self) -> None:
        """Force buffered lines to disk (a postmortem dump calls this first
        so the two artifacts never disagree on a torn line).  Never
        raises."""
        try:
            with self._lock:
                self._f.flush()
                os.fsync(self._f.fileno())
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass

    @classmethod
    def from_env(cls, environ=os.environ) -> "EventLog | None":
        """The opt-in hook: an EventLog when ``NLHEAT_EVENT_LOG`` is set
        and openable, else None (one loud stderr line on an unopenable
        path — a typo'd path must not silently drop the telemetry it
        asked for, and must not kill the run either)."""
        path = environ.get(EVENT_LOG_ENV)
        if not path:
            return None
        try:
            return cls(path)
        except OSError as e:
            print(f"[obs] {EVENT_LOG_ENV}={path!r} cannot be opened "
                  f"({e}); event log disabled", file=sys.stderr)
            return None


def read_jsonl(path) -> list:
    """Parse one JSONL event file tolerantly: a torn final line (a
    crashed writer) costs that line, never the file."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue
    return events


def merge_event_streams(streams) -> list:
    """Totally order multi-process event streams.

    ``streams`` is an iterable of event-dict lists (e.g. one
    :func:`read_jsonl` per replica file, or one combined file N
    replicas appended to).  Events are grouped by their process
    identity ``(pid, replica)``; WITHIN a process the per-process
    ``seq`` is authoritative (lifetime-exact, gap-free — clock skew can
    never reorder one process's own story); ACROSS processes the groups
    are heap-merged on the wall-clock ``t`` stamp of each group's head.
    Pre-seq lines (older logs) sort first within their process, in
    arrival order."""
    groups: dict = {}
    for events in streams:
        for i, ev in enumerate(events):
            key = (ev.get("pid"), ev.get("replica"))
            groups.setdefault(key, []).append((ev.get("seq", -1), i, ev))
    runs = []
    for key in sorted(groups, key=lambda k: (str(k[0]), str(k[1]))):
        run = [ev for _seq, _i, ev in sorted(groups[key],
                                             key=lambda x: (x[0], x[1]))]
        runs.append(run)
    heap = []
    for gi, run in enumerate(runs):
        if run:
            heapq.heappush(heap, (run[0].get("t", 0.0) or 0.0, gi, 0))
    out = []
    while heap:
        _t, gi, i = heapq.heappop(heap)
        out.append(runs[gi][i])
        if i + 1 < len(runs[gi]):
            heapq.heappush(
                heap, (runs[gi][i + 1].get("t", 0.0) or 0.0, gi, i + 1))
    return out


def merged_prometheus(registries) -> str:
    """One text exposition covering several registries.  Family TYPE lines
    are deduplicated on first sight; callers keep metric NAMES disjoint
    across registries (per-replica ``/replica{r}`` prefixes do) so each
    family's samples stay contiguous as the format wants."""
    seen: set = set()
    lines: list[str] = []
    for reg in registries:
        for line in reg.prometheus().splitlines():
            if line.startswith("# TYPE"):
                if line in seen:
                    continue
                seen.add(line)
            if line:
                lines.append(line)
    return "\n".join(lines) + "\n"


def merged_snapshot_json(registries) -> str:
    """The one-line JSON twin of :func:`merged_prometheus` (later
    registries win on a (disjoint-by-convention) name clash)."""
    merged: dict = {}
    for reg in registries:
        merged.update(reg.snapshot())
    return json.dumps(merged, default=float)


class MetricsServer:
    """The ``--metrics-port`` scrape endpoint (127.0.0.1 only).

    ``registry`` may be a registry, a zero-arg callable returning one
    (a live binding), or — either way — a LIST/TUPLE of registries: the
    scrape then AGGREGATES them into one exposition."""

    def __init__(self, port: int, registry):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        get_registry = registry if callable(registry) else (lambda: registry)

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    reg = get_registry()
                    regs = (list(reg) if isinstance(reg, (list, tuple))
                            else [reg])
                    if self.path.startswith("/metrics.json"):
                        body = merged_snapshot_json(regs).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = merged_prometheus(regs).encode()
                        ctype = "text/plain; version=0.0.4"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except Exception:  # noqa: BLE001 — a scrape must not kill us
                    try:
                        self.send_error(500)
                    except Exception:  # noqa: BLE001
                        pass

            def log_message(self, *a):  # silence per-request stderr chatter
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]  # resolved (port 0 = any)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="nlheat-metrics")
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001
            pass


def serve_metrics(port: int, registry) -> MetricsServer:
    """Start the scrape endpoint; ``registry`` is a MetricsRegistry or a
    zero-arg callable returning one (a live binding)."""
    return MetricsServer(port, registry)
