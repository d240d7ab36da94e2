"""Async serving runtime: continuous batching + overlapped chunk dispatch —
the port's copy of ``nonlocalheatequation_tpu/serve/server.py``.

The reference earns its scaling from HPX's asynchronous many-task model —
futures and dataflow overlapping communication, computation, and task
launch (README.md:12-14; the interior/boundary overlap at
src/2d_nonlocal_distributed.cpp:1156-1261).  The offline
:class:`~nonlocalheatequation_torch.serve.ensemble.EnsembleEngine` is the
opposite schedule: ``run()`` builds, dispatches, and fences one chunk at
a time, so the host idles while the card computes and the card idles while
the host builds and stages the next chunk.  This module applies the
reference's execution model to the request path:

* **Request lifecycle** — cases are :meth:`ServePipeline.submit`-ted
  incrementally (streaming stdin, a test harness), NOT as one pre-read
  batch.  Each request joins its bucket's OPEN chunk (the ensemble
  engine's ``(shape, nt, eps, test)`` keys); the chunk closes at size B
  (``window_size``, default the engine's top batch size) or after T ms
  (``window_ms``) — whichever first — so late arrivals join
  in-flight-adjacent chunks instead of waiting for EOF.
* **Overlapped dispatch** — up to D (``depth``) chunks stay in flight.
  A dispatch only enqueues kernels on the card's stream: launching chunk
  N+1 (and building chunk N+2's program, staging its state through
  page-locked memory with a non-blocking copy) proceeds while chunk N
  computes.  The host fences ONLY when a result is actually due (the pipe
  is full and more work waits, a caller waits on a request, or
  ``drain()``), via the scalar :func:`fence_scalar` fetch, and NEVER
  between dispatches.
* **Deadline-aware scheduling** — ``submit(deadline_ms=...)`` bounds a
  case's microbatch wait: the earliest deadline in an open chunk pulls
  the close forward (an aging case forces a partial chunk out,
  starvation-free — the window T is an upper bound for every case);
  ``priority`` orders READY chunks at equal dispatch capacity.
  ``drain()`` flushes all partial chunks and in-flight work.
* **Fault tolerance** (serve/resilience.py) — every chunk execution is
  SUPERVISED: the dispatch stage is guarded, the fence/fetch runs under
  a per-chunk deadline (``fetch_deadline_ms``: a watchdog thread joins
  the fetch and classifies a miss as a hang, ABANDONING the blocked
  thread — a thread blocked in a dead fetch is never killed), and the
  fetched buffer is finite-scanned (``nan_policy``).  A failed attempt
  (classified ``error``/``hang``/``corrupt``) retries with exponential
  backoff up to ``retries`` times; a chunk that exhausts its budget is
  BISECTED — split in half, both halves re-dispatched with fresh
  budgets — until the failing case is isolated, which then completes
  exceptionally (:meth:`ServeRequest.wait` raises a typed
  :class:`~nonlocalheatequation_torch.serve.resilience.ServeError`) while
  its chunk-mates are re-bucketed and served normally.  K consecutive
  device-path failures open a circuit breaker that routes chunks
  through the plain PyTorch program on the CPU (a declared, counted route:
  ``fallback_chunks``, the breaker's timestamped transitions) until a
  half-open probe re-closes it.  All of it is provable with no card via
  the deterministic injector in utils/faults.py (env
  ``NLHEAT_FAULT_PLAN`` or the ``faults=`` hook).  On the card an
  exception the plan did not inject (a kernel that does not build,
  launch or finish) is not classified: it propagates out of the
  pipeline, so a broken kernel never moves the stream to the CPU.
* **Observability** — :class:`ServeReport` extends the engine's report
  with per-request and per-chunk timing (queue wait, program build,
  dispatch->fence wall, fetch), an occupancy trace (chunks in flight
  over time), forced-close counts, the failure telemetry (retries,
  backoff, fault classifications, quarantined case ids, breaker
  transitions with timestamps, fallback-served chunk count), and a
  one-call JSON dump (:meth:`ServePipeline.metrics_json`).

Served results are **bitwise** ``EnsembleEngine.run()``'s on the same
case set: the pipeline reuses the engine's chunk stages (``pad_chunk`` /
``build_program`` / ``stage_inputs`` / ``dispatch_chunk``) verbatim — only
the schedule changes (tests/test_torch_serve.py pins this, plus the
no-fence-between-dispatches discipline via spy counters).  The port's
programs never write their input, so every attempt may re-stage freely
(the JAX package's donation guard has no counterpart here).

The SLO ledger (``slo=``, obs/slo.py) joins every submit's promise to its
retire or quarantine outcome under ``/slo/*`` on the report's registry and
feeds the device-routed chunks' per-apply times back into the tuner's
records as live rates.  The flight recorder (obs/flightrec.py), when one is
installed process-wide, mirrors every event into its ring, snapshots the
in-flight ledger, and dumps a postmortem on quarantine and on a breaker
opening.  Both take only timestamps the scheduler already took and add no
fence; off, each tap is one attribute read.

Threading note: the pipeline is single-threaded by design — the overlap
lives in the card's stream (asynchronous launches), not in host threads.
The one exception is the supervised fetch watchdog: a daemon thread that
runs the fence the scheduler would otherwise run inline, joined with the
per-chunk deadline — on a miss the thread is abandoned, never killed.
Corollary: window/deadline bounds are enforced at scheduler EVENTS
(``submit``/``pump``/``wait``/``drain``) — an intake that can stall for
long stretches between submissions should call ``pump()`` on its own
cadence, because no background thread fires the window for it.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from nonlocalheatequation_torch.obs import flightrec
from nonlocalheatequation_torch.obs import slo as obs_slo
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.export import EventLog
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry, backed
from nonlocalheatequation_torch.serve.ensemble import (
    EnsembleCase,
    EnsembleEngine,
    EnsembleReport,
)
from nonlocalheatequation_torch.serve.resilience import (
    CLASS_CORRUPT,
    CLASS_ERROR,
    CLASS_HANG,
    CircuitBreaker,
    CpuFallback,
    ServeError,
)
from nonlocalheatequation_torch.utils.faults import (
    NO_FAULTS,
    FaultPlan,
    InjectedFault,
)

#: Bound on every observability window (per-chunk log, latency/queue-wait
#: samples, occupancy trace, quarantine trail): a long-lived serving
#: process must not grow host memory with its request count, so
#: percentiles, stage totals, and the metrics dump cover the most recent
#: LOG_CAP entries — each window's companion ``count`` (obs/metrics.py
#: Trail/Histogram) and the counters (cases/dispatches/...) remain
#: lifetime-exact.
LOG_CAP = 4096


def fence_scalar(x) -> float:
    """The device fence: a scalar device->host fetch, which returns once
    every kernel queued before it on the stream has run (the reduction is
    queued behind the chunk's last launch).  Module-level on purpose — the
    no-fence-between-dispatches tests spy on exactly this symbol.  Non-finite sums
    are legal HERE (the fence only orders; it never judges) — what the
    supervised retire does with a non-finite FETCHED buffer is
    ``nan_policy``'s call (quarantine by default, ``"serve"`` restores
    the a-diverged-solve-is-a-legitimate-result behavior)."""
    return float(torch.sum(x))


@dataclass
class ServeRequest:
    """One submitted case: the caller's handle (a future).  ``result`` is
    populated when the request's chunk retires; ``wait()`` forces it and
    raises the typed ``ServeError`` if the case was quarantined
    (``error`` holds it either way)."""

    case: EnsembleCase
    seq: int
    submit_t: float
    priority: int = 0
    deadline_t: float | None = None
    #: trace identity (obs/trace.py TraceContext) when the case arrived
    #: through a traced front door; None otherwise (zero cost)
    trace: object = None
    #: engine-pool key when the case carries a picked engine
    #: (EnsembleEngine.engine_key axes); None = the pipeline's engine
    engine_sel: tuple | None = None
    result: np.ndarray | None = None
    error: ServeError | None = None
    queue_wait_s: float | None = None  # submit -> dispatch
    latency_s: float | None = None  # submit -> result
    #: the route of the attempt that served it: "device", or "fallback"
    #: (the CPU sibling engine, while the breaker was open)
    route: str | None = None
    _chunk: "_Chunk | None" = None
    _pipe: "ServePipeline | None" = None

    def wait(self) -> np.ndarray:
        return self._pipe.wait(self)


class _OpenChunk:
    """A bucket's accumulating chunk (not yet closed).  ``key`` is the
    OPEN-chunk key ``(bucket_key, engine_sel)`` — picked-engine cases
    never share a chunk with default-engine cases of the same bucket,
    because the two build different programs."""

    def __init__(self, key, opened_t):
        self.key = key
        self.opened_t = opened_t
        self.requests: list[ServeRequest] = []
        self.deadline_t: float | None = None
        self.priority = 0

    def due(self, now, window_s):
        if self.deadline_t is not None and now >= self.deadline_t:
            return "deadline"
        if now >= self.opened_t + window_s:
            return "window"
        return None


class _Chunk:
    """A closed chunk moving through ready -> inflight -> done, possibly
    looping back to ready on a supervised retry or being superseded by
    its two bisection halves."""

    def __init__(self, chunk_id, key, requests, priority, closed_by,
                 engine_sel=None):
        self.chunk_id = chunk_id
        self.key = key  # the BUCKET key (engine.build_program's shape)
        self.engine_sel = engine_sel  # picked-engine pool key, or None
        self.requests = requests
        self.priority = priority
        self.closed_by = closed_by
        self.state = "ready"
        self.out = None  # the result tensor once dispatched (its kernels queued)
        self.dispatch_t = None
        self.build_s = 0.0
        self.attempts = 0  # execution attempts so far (supervision)
        self.route = "device"  # this attempt's routing (device/fallback)
        self.probe = False  # this attempt IS the breaker's half-open probe
        self.fired = NO_FAULTS  # this attempt's armed injected faults
        self.padded = None  # pad_chunk result, computed once per chunk
        self.last_failure = ("", "")  # (classification, detail)


class ServeReport(EnsembleReport):
    """EnsembleReport extended with the serving pipeline's observability:
    per-chunk and per-request timing, occupancy, forced-close reasons,
    and the failure telemetry.  The engine counters (cases/buckets/
    dispatches/programs_built/padded_cases) keep their offline meaning —
    the pipeline routes the engine's own stages, so the same counters
    measure the same events (fallback-served chunks run on a sibling CPU
    engine and are counted by ``fallback_chunks`` instead).

    Like the engine counters, every field below is BACKED by the
    report's metrics registry (obs/metrics.py) under the ``/serve``
    namespace — the registry's Prometheus text and JSON snapshot agree
    with :meth:`metrics` on every shared counter by construction.  The
    windows (chunk log, latency/queue-wait samples, occupancy trace,
    quarantine trail) are bounded at LOG_CAP with lifetime-exact
    companion counts (the windowed-trail pattern the breaker transition
    log introduced)."""

    depth = backed("_m_depth")
    window_ms = backed("_m_window_ms")
    window_size = backed("_m_window_size")
    max_inflight = backed("_m_max_inflight")
    retries = backed("_m_retries")
    backoff_ms_total = backed("_m_backoff_ms_total")
    bisections = backed("_m_bisections")
    fallback_chunks = backed("_m_fallback_chunks")

    def __init__(self, depth: int = 1, window_ms: float = 0.0,
                 window_size: int = 0, breaker: object = None,
                 registry: MetricsRegistry | None = None):
        super().__init__(registry=registry)
        r = self.registry
        self._m_depth = r.gauge("/serve/depth")
        self._m_window_ms = r.gauge("/serve/window-ms")
        self._m_window_size = r.gauge("/serve/window-size")
        self._m_max_inflight = r.gauge("/serve/max-inflight")
        self._m_retries = r.counter("/serve/retries")
        self._m_backoff_ms_total = r.counter("/serve/backoff-ms-total")
        self._m_bisections = r.counter("/serve/bisections")
        self._m_fallback_chunks = r.counter("/serve/fallback-chunks")
        # bounded windows (LOG_CAP most recent entries; see the constant)
        self.chunk_log = r.trail("/serve/chunk-log", window=LOG_CAP)
        self.request_latency_ms = r.histogram("/serve/request-latency-ms",
                                              window=LOG_CAP)
        self.queue_wait_ms = r.histogram("/serve/queue-wait-ms",
                                         window=LOG_CAP)
        self.occupancy_samples = r.trail("/serve/occupancy",  # (t, n)
                                         window=LOG_CAP)
        self.quarantined = r.trail("/serve/quarantined", window=LOG_CAP)
        self.forced_closes = r.labeled("/serve/closes")
        self.faults = r.labeled("/serve/faults")  # classification -> count
        self.depth = depth
        self.window_ms = window_ms
        self.window_size = window_size
        self.breaker = breaker  # the pipeline's CircuitBreaker, if any

    def store(self) -> dict:
        """The program-store block of :meth:`metrics`, under the JAX
        package's keys: the store's hit/miss/save counters, refusals by
        reason and load/serialize-time percentiles (zero with the store
        off), plus the engine's LRU program-cache occupancy (resident
        gauge, lifetime evictions).  The keys are stable so
        dashboards need no existence checks."""
        r = self.registry

        def val(name):
            m = r.get(name)
            return m.value if m is not None else 0

        def pct(name):
            m = r.get(name)
            return m.percentiles() if m is not None else {}

        refusals = r.get("/store/refusals")
        return {
            "hits": val("/store/hits"),
            "misses": val("/store/misses"),
            "saves": val("/store/saves"),
            "refusals": dict(refusals) if refusals is not None else {},
            "load_ms": pct("/store/load-ms"),
            "serialize_ms": pct("/store/serialize-ms"),
            "resident_programs": val("/store/resident-programs"),
            "evictions": val("/store/evictions"),
        }

    def occupancy(self) -> dict:
        """Max and time-weighted mean chunks in flight over the sampled
        span (each sample is the in-flight count right after a dispatch
        or retire event)."""
        s = list(self.occupancy_samples)
        if not s:
            return {"max": 0, "time_weighted_mean": 0.0}
        span = s[-1][0] - s[0][0]
        if span <= 0:
            return {"max": self.max_inflight,
                    "time_weighted_mean": float(self.max_inflight)}
        area = sum(n * (s[i + 1][0] - s[i][0])
                   for i, (_t, n) in enumerate(s[:-1]))
        return {"max": self.max_inflight,
                "time_weighted_mean": float(area / span)}

    def resilience(self) -> dict:
        """The failure-telemetry block of :meth:`metrics`: retry/backoff
        totals, fault classifications, quarantined case ids, fallback
        chunk count, and the breaker's timestamped transition trail."""
        out = {
            "retries": self.retries,
            "faults": dict(self.faults),
            "backoff_ms_total": round(self.backoff_ms_total, 3),
            "bisections": self.bisections,
            "fallback_chunks": self.fallback_chunks,
            # windowed trail (LOG_CAP most recent) + lifetime-exact count
            "quarantined": [dict(q) for q in self.quarantined],
            "quarantined_total": self.quarantined.count,
        }
        if self.breaker is not None:
            out["breaker"] = {
                "state": self.breaker.state,
                "threshold": self.breaker.threshold,
                # most recent TRANSITION_CAP entries; the count is
                # lifetime-exact (a flapping breaker grows forever)
                "transition_count": self.breaker.transition_count,
                "transitions": [dict(t) for t in self.breaker.transitions],
            }
        else:
            out["breaker"] = {"state": "disabled", "transition_count": 0,
                              "transitions": []}
        return out

    def metrics(self) -> dict:
        """The one-call dump: engine counters (lifetime-exact) + pipeline
        knobs + latency percentiles + stage totals + occupancy + the
        failure telemetry + the per-chunk log, the latter four over the
        most recent ``LOG_CAP`` entries (``log_window`` in the dump,
        each window's lifetime-exact companion count alongside)."""
        return {
            "log_window": LOG_CAP,
            # lifetime-exact window companions: how many entries each
            # bounded window has EVER absorbed (== len until it wraps)
            "requests_completed": self.request_latency_ms.count,
            "chunks_completed": self.chunk_log.count,
            "occupancy_samples_total": self.occupancy_samples.count,
            "cases": self.cases,
            "buckets": self.buckets,
            # lifetime-exact (every chunk was closed exactly once —
            # bisection halves count as their own "bisect" closes; the
            # windowed chunk_log may hold fewer)
            "chunks": sum(self.forced_closes.values()),
            "dispatches": self.dispatches,
            "programs_built": self.programs_built,
            "programs_loaded": self.programs_loaded,
            "padded_cases": self.padded_cases,
            "depth": self.depth,
            "window_ms": self.window_ms,
            "window_size": self.window_size,
            "forced_closes": dict(self.forced_closes),
            "request_latency_ms": self.request_latency_ms.percentiles(),
            "queue_wait_ms": self.queue_wait_ms.percentiles(),
            "build_ms_total": round(
                sum(c["build_ms"] for c in self.chunk_log), 3),
            "device_ms_total": round(
                sum(c["device_ms"] for c in self.chunk_log), 3),
            "fetch_ms_total": round(
                sum(c["fetch_ms"] for c in self.chunk_log), 3),
            "occupancy": self.occupancy(),
            "resilience": self.resilience(),
            "store": self.store(),
            "chunk_log": list(self.chunk_log),
        }

    def metrics_json(self) -> str:
        return json.dumps(self.metrics())


class ServePipeline:
    """Continuous-batching scheduler with up to ``depth`` chunks in
    flight over one :class:`EnsembleEngine`, supervised end to end.

    Scheduling parameters: ``depth`` D (in-flight dispatch cap, >= 1; 1
    is the fenced A/B schedule), ``window_ms`` T (microbatch wait
    bound), ``window_size`` B (size trigger; defaults to the engine's
    top batch size so chunk partitioning matches the offline ``run()``
    exactly), ``clock`` (injectable for deterministic scheduler tests).

    Supervision parameters: ``retries`` (re-dispatches per chunk after
    its first attempt; bisection halves get fresh budgets),
    ``backoff_ms`` (base of the exponential per-chunk retry backoff,
    applied via the injectable ``sleep``), ``fetch_deadline_ms`` (per-
    chunk fence/fetch deadline; 0/None = no watchdog, the fence inline),
    ``fallback`` (route chunks through the CPU sibling engine while the
    breaker is open), ``breaker`` (a prebuilt
    :class:`~nonlocalheatequation_torch.serve.resilience.CircuitBreaker`;
    default one is built from ``breaker_threshold`` /
    ``breaker_cooldown_ms`` on the pipeline clock when ``fallback`` is
    on), ``nan_policy`` ("quarantine": a non-finite fetched buffer is a
    classified fault; "serve": a diverged solve is a legitimate result),
    ``faults`` (a deterministic
    :class:`~nonlocalheatequation_torch.utils.faults.FaultPlan`; defaults
    to env ``NLHEAT_FAULT_PLAN`` when set).  ``slo``: an
    :class:`~nonlocalheatequation_torch.obs.slo.SloLedger`, True (build
    one), False (off) or None (``NLHEAT_SLO=1`` decides).  With the engine on the card
    only injected errors, hangs and corrupt buffers are classified; any
    other exception ends the pipeline (:meth:`close` then skips its
    drain) and propagates.  Remaining kwargs construct
    the engine (method/precision/variant/device/...); like every entry
    point of the port it runs on the card unless ``device="cpu"``.
    """

    def __init__(self, engine: EnsembleEngine | None = None, *,
                 depth: int = 2, window_ms: float = 5.0,
                 window_size: int | None = None, clock=time.monotonic,
                 retries: int = 2, backoff_ms: float = 10.0,
                 fetch_deadline_ms: float | None = None,
                 fallback: bool = True, breaker: CircuitBreaker | None = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_ms: float = 5000.0,
                 nan_policy: str = "quarantine",
                 faults: FaultPlan | None = None, sleep=time.sleep,
                 registry: MetricsRegistry | None = None, tracer=None,
                 slo=None, **engine_kwargs):
        if engine is None:
            engine = EnsembleEngine(**engine_kwargs)
        elif engine_kwargs:
            raise ValueError(
                f"pass engine kwargs {sorted(engine_kwargs)} OR a built "
                "engine, not both")
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        ws = int(window_size if window_size is not None
                 else engine.batch_sizes[-1])
        if not 1 <= ws <= engine.batch_sizes[-1]:
            raise ValueError(
                f"window_size {ws} outside the engine batch sizes "
                f"{engine.batch_sizes} (max {engine.batch_sizes[-1]})")
        retries = int(retries)
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if backoff_ms < 0:
            raise ValueError(f"backoff_ms must be >= 0, got {backoff_ms}")
        if fetch_deadline_ms is not None and fetch_deadline_ms < 0:
            raise ValueError(
                f"fetch_deadline_ms must be >= 0, got {fetch_deadline_ms}")
        if nan_policy not in ("quarantine", "serve"):
            raise ValueError(
                f"nan_policy must be 'quarantine' or 'serve', got "
                f"{nan_policy!r}")
        if faults is None:
            faults = FaultPlan.from_env()
        if breaker is None and fallback:
            breaker = CircuitBreaker(threshold=breaker_threshold,
                                     cooldown_ms=breaker_cooldown_ms,
                                     clock=clock)
        # observability (obs/): the report and its registry, the span
        # tracer (an explicit one, else the process-global one — None
        # when tracing is off, the zero-cost path), and the opt-in JSONL
        # event log
        report = ServeReport(depth=depth, window_ms=window_ms,
                             window_size=ws, breaker=breaker,
                             registry=registry)
        self._tracer = (None if tracer is obs_trace.TRACE_OFF
                        else tracer if tracer is not None
                        else obs_trace.get_tracer())
        self._events = EventLog.from_env()
        # the crash flight recorder (obs/flightrec.py): the process-global
        # black box, bound to THIS pipeline's registry and in-flight ledger
        # (later pipelines re-bind).  None when off: every tap is one
        # attribute read.
        self._flightrec = flightrec.get_recorder()
        if self._flightrec is not None:
            self._flightrec.bind(registry=report.registry, inflight=self._inflight_ledger)
            if self._events is not None:
                self._flightrec.add_flush(self._events.flush)
        # the SLO promise-audit ledger (obs/slo.py): joins every submit's
        # promise to its retire/quarantine outcome under /slo/* on this
        # report's registry.  None when off.
        self._slo = obs_slo.SloLedger.from_arg(slo, registry=report.registry, clock=clock)
        self.registry = report.registry
        if breaker is not None:
            # mirror the breaker's lifetime-exact transition count into
            # the registry (a prebuilt breaker may arrive with history)
            self.registry.counter("/breaker/transitions").set(
                breaker.transition_count)
            breaker.on_transition = self._breaker_moved
        self.engine = engine
        self.depth = depth
        self.window_s = window_ms / 1e3
        self.window_size = ws
        self._clock = clock
        self._sleep = sleep
        self.retries = retries
        self.backoff_ms = float(backoff_ms)
        self.fetch_deadline_s = (fetch_deadline_ms / 1e3
                                 if fetch_deadline_ms else None)
        self.nan_policy = nan_policy
        self._faults = faults
        self._fallback_on = bool(fallback)
        #: the engine runs on the card: only injected faults are classified
        self.on_card = engine.device.type == "cuda"
        self._failed: BaseException | None = None
        self._fallback: CpuFallback | None = None
        #: picked-engine pool: engine_sel key -> sibling engine sharing
        #: this pipeline's report/registry, plus each sibling's own CPU
        #: fallback (a fallback chunk must run the CHUNK's integrator,
        #: not the default engine's)
        self._engines: dict = {}
        self._fallbacks: dict = {}
        self._breaker = breaker
        engine.adopt_report(report)
        self.report = report
        self._open: dict = {}
        self._ready: list[_Chunk] = []
        self._inflight: deque[_Chunk] = deque()
        self._seen_keys: set = set()
        self._next_seq = 0
        self._next_chunk = 0
        self._closed = False
        # retrace watchdog: armed by arm_steady_state() after warm-up;
        # any programs_built growth past the armed baseline is counted +
        # warned loudly
        self._steady_seen: int | None = None

    # -- observability emitters (obs/) --------------------------------------
    # All three are single-`if` no-ops when tracing/logging is off, emit
    # from timestamps the scheduler already took (no extra fences, no
    # extra clock reads on timed paths), and never raise (the tracer and
    # event log swallow their own failures).
    def _t_span(self, name: str, t0, t1, **args) -> None:
        tr = self._tracer
        if tr is not None:
            tr.complete(name, t0, t1, cat="serve", **args)

    def _t_instant(self, name: str, ts=None, **args) -> None:
        tr = self._tracer
        if tr is not None:
            tr.instant(name, ts=ts if ts is not None else self._clock(),
                       cat="serve", **args)

    def _t_inflight(self, ts, n: int) -> None:
        tr = self._tracer
        if tr is not None:
            tr.counter("serve.inflight", ts=ts, inflight=n)

    def _event(self, kind: str, **fields) -> None:
        """One discrete event, mirrored to both sinks: the JSONL event log
        and the flight recorder's ring.  One attribute read per sink when
        off; never raises."""
        if self._events is not None:
            self._events.emit(event=kind, **fields)
        fr = self._flightrec
        if fr is not None:
            fr.record(kind, **fields)

    def _inflight_ledger(self) -> list:
        """The flight recorder's in-flight snapshot: every chunk not yet
        done, with its member case seqs.  Bounded by depth + ready."""
        out = []
        try:
            for oc in self._open.values():
                out.append({"state": "open", "cases": [r.seq for r in oc.requests]})
            for ch in list(self._ready):
                out.append({"state": "ready", "chunk": ch.chunk_id,
                            "cases": [r.seq for r in ch.requests]})
            for ch in list(self._inflight):
                out.append({"state": "inflight", "chunk": ch.chunk_id,
                            "cases": [r.seq for r in ch.requests]})
        except Exception:  # noqa: BLE001 — a racing mutation costs the
            pass  # remainder of the ledger, never the dump
        return out

    def _breaker_moved(self, frm: str, to: str, t: float) -> None:
        """CircuitBreaker transition hook: mirror into the registry, the
        trace, and the event log (the trail itself lives on the breaker,
        surfaced by :meth:`ServeReport.resilience`).  A closed -> open move
        also dumps the flight recorder: the breaker opening is the device
        path failing, and the black box should say why."""
        try:
            self.registry.counter("/breaker/transitions").inc()
            self._t_instant("breaker.transition", ts=t,
                            **{"from": frm, "to": to})
            # breaker_t, not t: the breaker's clock is the pipeline's
            # (monotonic/injected) — the bare "t" stamp on every EventLog
            # line is the WALL clock the cross-process merge keys on
            self._event("breaker", breaker_t=t, frm=frm, to=to)
            fr = self._flightrec
            if fr is not None and to == "open":
                fr.dump("breaker-open", frm=frm, breaker_t=t)
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    # -- intake -------------------------------------------------------------
    def submit(self, case: EnsembleCase, *, deadline_ms: float | None = None,
               priority: int = 0, trace=None,
               engine=None, sticky_key=None) -> ServeRequest:
        """Queue one case; returns its handle.  ``deadline_ms`` (relative
        to now) pulls the case's chunk close forward; ``priority`` orders
        ready chunks competing for a dispatch slot.  ``trace`` is the
        originating request's TraceContext (obs/trace.py): it is
        re-installed around this case's chunk stages so every span nests
        under it; None (the default) costs nothing.  ``engine`` is a
        picked engine — an object with ``.key()`` or the key tuple
        ``(stepper, stages, method, precision)`` of
        :meth:`EnsembleEngine.engine_for`: the case is served by that
        sibling from the pipeline's engine pool, with the same supervision
        and schedule and its own programs; None (the default) is the
        pipeline's engine.  ``sticky_key`` is the routing identity a
        replica router honors in the JAX package; accepted here so the
        submit surface is the same, and deliberately inert: an in-process
        pipeline owns every bucket."""
        del sticky_key
        if self._closed:
            raise RuntimeError("pipeline is closed")
        now = self._clock()
        sel = None
        if engine is not None:
            sel = engine.key() if hasattr(engine, "key") else tuple(engine)
            if sel == self.engine.engine_key():
                sel = None  # the pick IS the default engine
        req = ServeRequest(case=case, seq=self._next_seq, submit_t=now,
                           priority=int(priority), trace=trace,
                           engine_sel=sel, _pipe=self)
        self._next_seq += 1
        self.report.cases += 1
        okey = (case.bucket_key(), sel)
        if okey not in self._seen_keys:
            self._seen_keys.add(okey)
            self.report.buckets += 1
        oc = self._open.get(okey)
        if oc is None:
            oc = self._open[okey] = _OpenChunk(okey, now)
        oc.requests.append(req)
        oc.priority = max(oc.priority, req.priority)
        if deadline_ms is not None:
            req.deadline_t = now + deadline_ms / 1e3
            oc.deadline_t = (req.deadline_t if oc.deadline_t is None
                             else min(oc.deadline_t, req.deadline_t))
        if self._slo is not None:
            # the promise half of the audit: the submit timestamp the
            # scheduler already took, the pick's modeled cost when the
            # caller picked (EngineChoice.est_ms), the axis either way
            self._slo.promise(req.seq, engine=engine, engine_sel=sel,
                              deadline_ms=deadline_ms, mesh=case.mesh, t=now)
        if len(oc.requests) >= self.window_size:
            self._close(okey, "size")
        self.pump()
        return req

    # -- scheduling ---------------------------------------------------------
    def pump(self) -> None:
        """Advance the pipeline: close chunks whose window or deadline is
        due, then dispatch while capacity lasts.  When the pipe is full
        AND more work waits, the oldest in-flight chunk's result is due —
        that retire is the ONLY fence this schedule ever takes outside
        wait()/drain()."""
        now = self._clock()
        for key in list(self._open):
            why = self._open[key].due(now, self.window_s)
            if why:
                self._close(key, why)
        while self._ready:
            if len(self._inflight) < self.depth:
                self._dispatch(self._pop_ready())
            else:
                self._retire(self._inflight[0])

    def _close(self, okey, why: str) -> _Chunk:
        oc = self._open.pop(okey)
        bucket, sel = okey
        chunk = _Chunk(self._next_chunk, bucket, oc.requests, oc.priority,
                       why, engine_sel=sel)
        self._next_chunk += 1
        for r in oc.requests:
            r._chunk = chunk
        self._ready.append(chunk)
        fc = self.report.forced_closes
        fc[why] = fc.get(why, 0) + 1
        self._t_instant("serve.close", chunk=chunk.chunk_id, why=why,
                        cases=len(oc.requests))
        return chunk

    def _pop_ready(self) -> _Chunk:
        # highest priority first; FIFO (chunk_id) within a priority —
        # starvation-free because every chunk's CLOSE is window-bounded
        # and the dispatch loop drains _ready completely (a retried chunk
        # keeps its chunk_id, so it also keeps its FIFO slot)
        best = min(self._ready, key=lambda c: (-c.priority, c.chunk_id))
        self._ready.remove(best)
        return best

    # -- supervised execution -----------------------------------------------
    def _route(self) -> str:
        """Breaker routing for the next chunk execution."""
        if self._breaker is None:
            return "device"
        route = self._breaker.route()
        if route == "fallback" and self._ensure_fallback() is None:
            return "device"  # fallback off: keep trying the device
        return route

    def _ensure_fallback(self) -> CpuFallback | None:
        """The default engine's CPU fallback, built at first use (the
        happy path never pays for it); None when ``fallback`` is off.  The
        CPU is always there, so a sibling that cannot be built raises out
        of the chunk's attempt (classified, never a silent route)."""
        if self._fallback is None and self._fallback_on:
            self._fallback = CpuFallback(self.engine)
        return self._fallback

    def _engine_for(self, sel) -> EnsembleEngine:
        """The chunk's engine: the pipeline's own for ``sel`` None, else
        the picked sibling from the pool (built once per engine key;
        adopt_report shares this pipeline's counters/registry, so the
        metrics dumps stay one report)."""
        if sel is None:
            return self.engine
        e = self._engines.get(sel)
        if e is None:
            e = self.engine.engine_for(*sel)
            if e is not self.engine:
                e.adopt_report(self.report)
            self._engines[sel] = e
        return e

    def _fallback_for(self, chunk: _Chunk) -> CpuFallback | None:
        """The chunk's CPU fallback: the default one for default-engine
        chunks; a per-pick sibling otherwise (a fallback must run the
        chunk's OWN integrator/method or the result would be a
        different scheme wearing the pick's name)."""
        if chunk.engine_sel is None:
            return self._ensure_fallback()
        if self._ensure_fallback() is None:
            return None
        fb = self._fallbacks.get(chunk.engine_sel)
        if fb is None:
            fb = CpuFallback(self._engine_for(chunk.engine_sel))
            self._fallbacks[chunk.engine_sel] = fb
        return fb

    def _dispatch(self, chunk: _Chunk) -> None:
        """One supervised execution attempt: route, arm injected faults,
        pad (once per chunk) + build + stage + dispatch through the
        engine's stages.  Fallback-routed chunks complete synchronously
        (their fetch is its own fence) and never enter the in-flight
        window; device-routed chunks only queue their kernels — no
        fence."""
        chunk.attempts += 1
        chunk.route = self._route()
        # tag the half-open probe: only ITS outcome may settle the probe
        # slot — a stale device chunk retiring mid-probe must not
        chunk.probe = (self._breaker is not None
                       and chunk.route == "device"
                       and self._breaker.routed_probe)
        chunk.fired = (self._faults.draw([r.seq for r in chunk.requests])
                       if self._faults is not None else NO_FAULTS)
        # install the chunk's originating TraceContext for the duration of
        # the dispatch stages, so every span recorded inside (serve.build/
        # dispatch AND the engine spans those stages emit) carries the
        # request's trace id.  Guarded by the tracer: the disabled path
        # stays one attribute read, zero clock reads.
        _ctx_installed = False
        _ctx_prev = None
        if self._tracer is not None:
            _ctx = next((r.trace for r in chunk.requests
                         if r.trace is not None), None)
            if _ctx is not None:
                _ctx_prev = obs_trace.set_context(_ctx)
                _ctx_installed = True
        try:
            self._dispatch_body(chunk)
        finally:
            if _ctx_installed:
                obs_trace.set_context(_ctx_prev)

    def _dispatch_body(self, chunk: _Chunk) -> None:
        t0 = self._clock()
        try:
            # INSIDE the classifying try: a picked-sibling construction
            # error must fail the chunk through the supervised
            # retry/bisect/quarantine path, never unwind out of pump()
            # with the chunk already popped from the ready queue
            engine = self._engine_for(chunk.engine_sel)
            if chunk.fired.raise_ is not None:
                raise InjectedFault(chunk.fired.raise_,
                                    self._faults.attempt - 1)
            if chunk.padded is None:
                chunk.padded = engine.pad_chunk(
                    [r.case for r in chunk.requests])
            if chunk.route == "fallback":
                chunk.build_s = 0.0
                chunk.dispatch_t = self._clock()
                self._record_queue_wait(chunk)
                # no fetch deadline on the fallback: it is the host's own
                # synchronous CPU computation, so there is nothing for the
                # hang watchdog to guard; an armed stall still classifies
                # (the inline path's immediate hang)
                outcome, t1, payload = self._guarded(
                    chunk, lambda: self._fetch_fallback(chunk),
                    deadline_s=None)
                ok = self._complete_attempt(chunk, outcome, t1, payload)
                # the EFFECTIVE outcome: _complete_attempt's finite scan
                # can reclassify a fetched-ok payload as corrupt (the
                # end-of-span clock read stays behind the tracer guard)
                if self._tracer is not None:
                    self._t_span("serve.fallback", t0, self._clock(),
                                 chunk=chunk.chunk_id,
                                 attempt=chunk.attempts,
                                 outcome="ok" if ok else
                                 (chunk.last_failure[0] or outcome))
                if ok:
                    self.report.fallback_chunks += 1
                    self._event("fallback-chunk", chunk=chunk.chunk_id,
                                cases=len(chunk.requests))
                return
            multi = engine.build_program(chunk.key, chunk.padded)
            self._check_steady_state()
            # every attempt re-stages (the programs never write their input)
            U0 = engine.stage_inputs(chunk.padded)
            chunk.build_s = self._clock() - t0
            chunk.dispatch_t = self._clock()
            chunk.out = engine.dispatch_chunk(multi, U0)  # kernels queued
        except Exception as e:  # noqa: BLE001 — classified, or fatal on the card
            if self._tracer is not None:
                self._t_span("serve.build", t0, self._clock(),
                             chunk=chunk.chunk_id, attempt=chunk.attempts,
                             error=type(e).__name__)
            self._raise_card_fault(e)
            self._attempt_failed(chunk, CLASS_ERROR, e)
            return
        # spans from the timestamps the scheduler already took: the
        # host-side pad/build/stage stage, then the (async) launch
        self._t_span("serve.build", t0, chunk.dispatch_t,
                     chunk=chunk.chunk_id, attempt=chunk.attempts)
        self._t_instant("serve.dispatch", ts=chunk.dispatch_t,
                        chunk=chunk.chunk_id, attempt=chunk.attempts,
                        route=chunk.route)
        chunk.state = "inflight"
        self._inflight.append(chunk)
        self._record_queue_wait(chunk)
        n = len(self._inflight)
        self.report.max_inflight = max(self.report.max_inflight, n)
        self.report.occupancy_samples.append((chunk.dispatch_t, n))
        self._t_inflight(chunk.dispatch_t, n)

    def _raise_card_fault(self, exc: BaseException) -> None:
        """Re-raise ``exc`` when it is a real failure on the card: an engine
        on cuda whose build, stage, launch or fetch raised something the
        fault plan did not inject.  Classifying it would feed the breaker
        and let the CPU fallback serve in the card's place; the pipeline is
        marked failed instead."""
        if self.on_card and not isinstance(exc, InjectedFault):
            self._failed = exc
            raise exc

    def _record_queue_wait(self, chunk: _Chunk) -> None:
        # queue wait means submit -> FIRST dispatch that actually staged
        # (a first attempt that dies in the dispatch stage never set
        # dispatch_t, so the retry records it instead); recorded once per
        # request — bisection halves keep their parent's sample
        for r in chunk.requests:
            if r.queue_wait_s is None:
                r.queue_wait_s = chunk.dispatch_t - r.submit_t
                self.report.queue_wait_ms.append(r.queue_wait_s * 1e3)

    def _fetch_device(self, chunk: _Chunk):
        """Fence + fetch one in-flight chunk (the supervised body; runs
        inline, or inside the watchdog thread when a deadline is set)."""
        if chunk.fired.stall is not None:
            # the injected hang: blocks until the supervisor's
            # classification (or close) releases it — it can never
            # "finish early" under host load, and it touches no CUDA
            chunk.fired.stall.wait()
        fence_scalar(chunk.out)  # device completion barrier
        t1 = self._clock()
        return t1, chunk.out.cpu().numpy()  # host fetch

    def _fetch_fallback(self, chunk: _Chunk):
        # no stall wait here: the only caller runs deadline-free, and
        # _guarded's no-deadline path classifies an armed stall before
        # this body is ever entered
        vals = self._fallback_for(chunk).run_chunk(chunk.key, chunk.padded)
        return self._clock(), vals

    def _guarded(self, chunk: _Chunk, fn, deadline_s="use-default"):
        """Run one fetch under the per-chunk deadline.  Returns
        ``(outcome, t_fence, payload)`` where outcome is "ok" (payload =
        fetched values), CLASS_ERROR (payload = the exception), or
        CLASS_HANG (payload = None).  Without a deadline the fetch runs
        inline — no thread; an armed stall is then classified
        immediately instead of blocking the scheduler forever."""
        if deadline_s == "use-default":
            deadline_s = self.fetch_deadline_s
        if deadline_s is None:
            if chunk.fired.stall is not None:
                chunk.fired.stall.set()
                return CLASS_HANG, self._clock(), None
            try:
                t1, vals = fn()
            except Exception as e:  # noqa: BLE001
                return CLASS_ERROR, self._clock(), e
            return "ok", t1, vals
        box: dict = {}
        # the card the chunk's result lives on (an indexed device; the
        # engine's may be the bare "cuda")
        device = getattr(chunk.out, "device", None)

        def worker():
            try:
                if device is not None and device.type == "cuda":
                    # a new thread's current card is card 0: the fence and
                    # the fetch must run on the chunk's
                    torch.cuda.set_device(device)
                box["t1"], box["vals"] = fn()
            except Exception as e:  # noqa: BLE001
                box["exc"] = e

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        th.join(deadline_s)
        if th.is_alive():
            # deadline missed: classify a hang and ABANDON the thread —
            # a daemon thread blocked in a dead fetch costs nothing, and
            # killing it could leave the card's context half-used.  Only
            # THIS chunk's injected stall is released (so its worker exits
            # promptly) — releasing every armed stall would defuse faults
            # on OTHER in-flight chunks whenever a genuinely slow fence
            # trips the deadline, making injected outcomes depend on
            # interleaving; close() still releases everything.
            if chunk.fired.stall is not None:
                chunk.fired.stall.set()
            return CLASS_HANG, self._clock(), None
        if "exc" in box:
            return CLASS_ERROR, self._clock(), box["exc"]
        return "ok", box["t1"], box["vals"]

    def _scan(self, chunk: _Chunk, vals):
        """Post-fetch corruption check (+ the injector's nan hook)."""
        if chunk.fired.nan is not None:
            vals = self._faults.apply_nan(
                chunk.fired, vals, [r.seq for r in chunk.requests])
        if self.nan_policy == "quarantine" \
                and not np.all(np.isfinite(vals)):
            return CLASS_CORRUPT, vals
        return "ok", vals

    def _release_stalls(self) -> None:
        if self._faults is not None:
            self._faults.release_stalls()

    def _record_breaker(self, chunk: _Chunk, ok: bool) -> None:
        if self._breaker is None or chunk.route != "device":
            return
        if ok:
            self._breaker.record_success(probe=chunk.probe)
        else:
            self._breaker.record_failure(probe=chunk.probe)

    def _attempt_failed(self, chunk: _Chunk, classification: str,
                        exc=None) -> None:
        """Classify, count, and decide: bounded retry with exponential
        backoff, bisection, or quarantine."""
        chunk.out = None  # drop the result tensor; retries re-stage
        f = self.report.faults
        f[classification] = f.get(classification, 0) + 1
        # corruption is DATA-shaped: a legitimately divergent input
        # reproduces its NaNs on any backend, and the device path DID
        # execute and deliver a buffer — so the breaker records a
        # SUCCESS (clearing a half-open probe; never opening on bad
        # data); only error/hang attest to device-path ill-health
        self._record_breaker(chunk, ok=(classification == CLASS_CORRUPT))
        detail = f"{type(exc).__name__}: {exc}" if exc is not None else ""
        chunk.last_failure = (classification, detail)
        if chunk.attempts <= self.retries:
            self.report.retries += 1
            delay_s = (self.backoff_ms / 1e3) * (2 ** (chunk.attempts - 1))
            self._t_instant("serve.retry", chunk=chunk.chunk_id,
                            attempt=chunk.attempts,
                            classification=classification,
                            backoff_ms=delay_s * 1e3)
            self._event("retry", chunk=chunk.chunk_id,
                        attempt=chunk.attempts,
                        classification=classification)
            if delay_s > 0:
                self.report.backoff_ms_total += delay_s * 1e3
                self._sleep(delay_s)
            chunk.state = "ready"
            self._ready.append(chunk)
            return
        if len(chunk.requests) > 1:
            self._bisect(chunk)
        else:
            self._quarantine(chunk, classification, detail)

    def _bisect(self, chunk: _Chunk) -> None:
        """Poison isolation: split the exhausted chunk in half; both
        halves re-enter the ready queue as fresh chunks (fresh attempt
        budgets, re-padded on dispatch).  Repeated, this isolates the
        failing case in O(log B) extra chunk executions while every
        chunk-mate is re-bucketed and served normally."""
        mid = len(chunk.requests) // 2
        self.report.bisections += 1
        self._t_instant("serve.bisect", chunk=chunk.chunk_id,
                        cases=len(chunk.requests),
                        halves=[self._next_chunk, self._next_chunk + 1])
        fc = self.report.forced_closes
        for part in (chunk.requests[:mid], chunk.requests[mid:]):
            half = _Chunk(self._next_chunk, chunk.key, part,
                          chunk.priority, "bisect",
                          engine_sel=chunk.engine_sel)
            self._next_chunk += 1
            for r in part:
                r._chunk = half
            fc["bisect"] = fc.get("bisect", 0) + 1
            self._ready.append(half)
        chunk.state = "done"  # superseded by its halves

    def _quarantine(self, chunk: _Chunk, classification: str,
                    detail: str) -> None:
        """The isolated poison case completes exceptionally."""
        req = chunk.requests[0]
        req.error = ServeError(classification, req.seq, chunk.chunk_id,
                               chunk.attempts, detail)
        req.latency_s = self._clock() - req.submit_t
        self.report.quarantined.append({
            "case": req.seq, "classification": classification,
            "attempts": chunk.attempts, "chunk": chunk.chunk_id})
        self._t_instant("serve.quarantine", case=req.seq,
                        chunk=chunk.chunk_id,
                        classification=classification,
                        attempts=chunk.attempts)
        self._event("quarantine", case=req.seq, chunk=chunk.chunk_id,
                    classification=classification,
                    attempts=chunk.attempts, detail=detail)
        if self._slo is not None:
            # the exceptional outcome resolves the promise too
            self._slo.resolve(req.seq, latency_s=req.latency_s,
                              queue_wait_s=req.queue_wait_s, error=classification)
        fr = self._flightrec
        if fr is not None:
            # a typed ServeError quarantine is a black-box trigger: the
            # postmortem names the poison case and what was in flight
            fr.dump("quarantine", case=req.seq, classification=classification,
                    detail=detail)
        chunk.state = "done"

    def _complete_attempt(self, chunk: _Chunk, outcome, t_fence,
                          payload) -> bool:
        """The shared tail of one supervised execution attempt, for both
        routes: scan the fetched buffer, then finish the chunk or
        classify the failure (retry / bisect / quarantine).  Returns
        True when the chunk finished with results."""
        if outcome == "ok":
            outcome, payload = self._scan(chunk, payload)
            if outcome == "ok":
                self._record_breaker(chunk, ok=True)
                self._finish(chunk, payload, t_fence)
                return True
            self._attempt_failed(chunk, outcome)
            return False
        if outcome == CLASS_ERROR:
            self._raise_card_fault(payload)
        self._attempt_failed(
            chunk, outcome, payload if outcome == CLASS_ERROR else None)
        return False

    def _retire(self, chunk: _Chunk) -> None:
        """Fence + fetch one in-flight chunk under supervision and
        distribute its lanes (or classify the failure)."""
        self._inflight.remove(chunk)
        t_f0 = None
        _ctx_installed = False
        _ctx_prev = None
        if self._tracer is not None:
            t_f0 = self._clock()
            # stamp the retire-side spans with the originating request's
            # trace (the dispatch-side twin lives in _dispatch)
            _ctx = next((r.trace for r in chunk.requests
                         if r.trace is not None), None)
            if _ctx is not None:
                _ctx_prev = obs_trace.set_context(_ctx)
                _ctx_installed = True
        try:
            outcome, t1, payload = self._guarded(
                chunk, lambda: self._fetch_device(chunk))
            ok = self._complete_attempt(chunk, outcome, t1, payload)
            t_now = self._clock()
            if t_f0 is not None:
                # the fetch span reuses the fence the retire performs
                # anyway; like serve.fallback it reports the EFFECTIVE
                # outcome — _complete_attempt's finite scan can
                # reclassify a fetched-ok payload as corrupt
                self._t_span("serve.fetch", t_f0, t_now,
                             chunk=chunk.chunk_id,
                             attempt=chunk.attempts,
                             outcome="ok" if ok else
                             (chunk.last_failure[0] or outcome))
        finally:
            if _ctx_installed:
                obs_trace.set_context(_ctx_prev)
        self.report.occupancy_samples.append((t_now, len(self._inflight)))
        self._t_inflight(t_now, len(self._inflight))

    def _finish(self, chunk: _Chunk, vals, t_fence) -> None:
        """Distribute a retired chunk's lanes (padding lanes dropped)."""
        t2 = self._clock()
        for j, r in enumerate(chunk.requests):
            r.result = np.asarray(vals[j])
            r.route = chunk.route
            r.latency_s = t2 - r.submit_t
            self.report.request_latency_ms.append(r.latency_s * 1e3)
        tr = self._tracer
        if tr is not None:
            # flow FINISH per traced request, at the retire timestamp the
            # scheduler already took: Perfetto binds it (bp="e") to the
            # enclosing serve.fetch/serve.fallback span (obs/trace.py)
            for r in chunk.requests:
                if r.trace is not None:
                    tr.flow("request", "finish", r.trace.trace_id,
                            ts=t2, cat="serve", req=r.seq,
                            chunk=chunk.chunk_id)
        chunk.state = "done"
        chunk.out = None
        entry = {
            "chunk": chunk.chunk_id,
            "cases": len(chunk.requests),
            "closed_by": chunk.closed_by,
            "build_ms": round(chunk.build_s * 1e3, 3),
            "device_ms": round((t_fence - chunk.dispatch_t) * 1e3, 3),
            "fetch_ms": round((t2 - t_fence) * 1e3, 3),
            "route": chunk.route,
            "attempt": chunk.attempts,
        }
        self.report.chunk_log.append(entry)
        self._event("chunk", **entry)
        if self._slo is not None:
            self._slo_retire(chunk, entry, t2)

    def _slo_retire(self, chunk: _Chunk, entry: dict, t2) -> None:
        """The outcome half of the audit (obs/slo.py): resolve every retired
        request's promise from the timestamps the retire already took, then
        feed the live rate recorder the chunk's per-apply milliseconds
        (device-routed chunks only: CPU-fallback walls must not recalibrate
        the card's picks).  Never raises."""
        sl = self._slo
        B = len(chunk.requests)
        dev_ms = entry["device_ms"]
        for r in chunk.requests:
            sl.resolve(r.seq, latency_s=r.latency_s, queue_wait_s=r.queue_wait_s,
                       device_ms=dev_ms / B, t=t2)
        if chunk.route != "device" or dev_ms <= 0:
            return
        try:
            case = chunk.requests[0].case
            if case.mesh is not None:
                # mesh-axis rate keys use the mesh's effective eps
                # (serve/picker.py _mesh_eps_eff), which needs the cloud
                return
            engine = self._engine_for(chunk.engine_sel)
            live = sl.ensure_live(self._device_kind(),
                                  dtype_name=str(engine.dtype).replace("torch.", ""))
            if live is None:
                return
            lanes = len(chunk.padded) if chunk.padded else B
            applies = obs_slo.applies_per_step(engine.stepper, engine.stages)
            per_apply = dev_ms / (lanes * max(1, int(case.nt)) * applies)
            live.record(engine.method, case.shape, case.eps, engine.precision, per_apply)
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def _device_kind(self) -> str:
        """The live-rate key's card name (``autotune.card_name`` of the
        engine's device), looked up once, after a chunk has retired."""
        dk = getattr(self, "_device_kind_cached", None)
        if dk is None:
            from nonlocalheatequation_torch.utils.autotune import card_name

            dk = self._device_kind_cached = card_name(self.engine.device)
        return dk

    # -- completion ---------------------------------------------------------
    def wait(self, req: ServeRequest) -> np.ndarray:
        """Force one request to completion (an implicit immediate
        deadline): close its open chunk if still accumulating, dispatch
        through the normal capacity discipline, fence its chunk.  Raises
        the typed ``ServeError`` if the case was quarantined."""
        while req.result is None and req.error is None:
            ch = req._chunk
            if ch is None:
                self._close((req.case.bucket_key(), req.engine_sel),
                            "wait")
            elif ch.state == "ready":
                if len(self._inflight) >= self.depth:
                    self._retire(self._inflight[0])
                else:
                    self._dispatch(self._pop_ready())
            else:  # inflight
                self._retire(ch)
        if req.error is not None:
            raise req.error
        return req.result

    def drain(self) -> None:
        """Flush everything: close all partial chunks, dispatch them
        (retiring as capacity demands), then retire all in-flight work —
        including any retries and bisection halves a failure re-queues.
        Quarantined requests do NOT raise here; their handles carry the
        ``ServeError`` (``wait()`` raises it)."""
        for key in list(self._open):
            self._close(key, "drain")
        while self._ready or self._inflight:
            if self._ready and len(self._inflight) < self.depth:
                self._dispatch(self._pop_ready())
            else:
                self._retire(self._inflight[0])

    def serve_cases(self, cases) -> list:
        """Convenience: submit every case, drain, return results in
        submission order — the schedule-changed twin of
        ``EnsembleEngine.run()`` (bitwise the same output).  A quarantined
        case's slot holds None (its handle carries the ServeError)."""
        handles = [self.submit(c) for c in cases]
        self.drain()
        return [h.result for h in handles]

    def close(self) -> None:
        """Drain and release the pipeline.  Any armed or abandoned
        injected stalls are released and the event log is closed even if
        the final drain raises, so no test leaks a blocked thread.  A
        pipeline that a card fault ended is released without a drain."""
        if not self._closed:
            try:
                if self._failed is None:
                    self.drain()
            finally:
                self._release_stalls()
                if self._slo is not None:
                    self._slo.close()  # flush buffered live rates
                if self._events is not None:
                    self._events.close()
                self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- observability ------------------------------------------------------
    def metrics(self) -> dict:
        m = self.report.metrics()
        if self._slo is not None:
            m["slo"] = self._slo.summary()
        return m

    def metrics_json(self) -> str:
        return json.dumps(self.metrics())

    # -- retrace watchdog ---------------------------------------------------
    def arm_steady_state(self) -> int:
        """Arm the rebuild watchdog: a steady-state server (warmed program
        caches) should build ZERO new programs — call this after warm-up,
        and every later ``programs_built`` growth increments
        ``/store/steady-state-builds`` plus a LOUD stderr warning and an
        event-log line, so a silent rebuild storm is seen.  Returns the
        armed baseline."""
        self._steady_seen = int(self.report.programs_built)
        # materialize the counter at arm time: a scrape sees the key
        # (value 0) even before any violation
        self.registry.counter("/store/steady-state-builds")
        return self._steady_seen

    def _check_steady_state(self) -> None:
        """Post-build hook (one int compare when armed, one attribute
        read when not): count + warn on programs built past the armed
        baseline."""
        seen = self._steady_seen
        if seen is None:
            return
        built = int(self.report.programs_built)
        if built <= seen:
            return
        delta = built - seen
        self._steady_seen = built
        self.registry.counter("/store/steady-state-builds").inc(delta)
        print(f"serve: WARNING steady-state rebuild — {delta} new "
              f"program(s) built after warm-up ({built} total) "
              "(/store/steady-state-builds)", file=sys.stderr)
        self._event("steady-state-build", built=built, delta=delta)


def serve_fence_ab(engine: EnsembleEngine, cases, depth: int,
                   iters: int = 2):
    """The pipelined-vs-fenced measurement: time the fenced (depth 1 — a
    dispatch+fence roundtrip per chunk, ``--ensemble``'s schedule) and
    pipelined (``depth`` in flight, fence only on retire) schedules of the
    SAME case set over ONE engine, in turns, so the shared program cache
    makes this an A/B of schedules, not builds.  The first pipelined pass
    warms the cache and its wall is returned as the build time.  Returns
    ``(build_s, fenced_best_s, pipelined_best_s, best_pipelined_report)``."""

    def run_schedule(d):
        pipe = ServePipeline(engine=engine, depth=d, window_ms=0.0)
        try:
            t0 = time.perf_counter()
            pipe.serve_cases(cases)
            return time.perf_counter() - t0, pipe.report
        finally:
            pipe.close()

    compile_s, _ = run_schedule(depth)
    fenced_best = float("inf")
    pipe_best, pipe_rep = float("inf"), None
    for _ in range(iters):
        sec_f, _ = run_schedule(1)
        fenced_best = min(fenced_best, sec_f)
        sec_p, rep = run_schedule(depth)
        if sec_p < pipe_best:
            pipe_best, pipe_rep = sec_p, rep
    return compile_s, fenced_best, pipe_best, pipe_rep


def serve_traced_ab(engine: EnsembleEngine, cases, depth: int,
                    iters: int = 2):
    """The traced-vs-untraced measurement: time the SAME pipelined schedule
    of ``cases`` over ONE engine twice per iter — once with tracing off
    (the zero-cost disabled path) and once with a span
    :class:`~nonlocalheatequation_torch.obs.trace.Tracer` installed on the
    pipeline — so the ratio isolates the host-side cost of recording
    spans.  The first traced pass warms the program cache and its wall is
    the build time.  Returns ``(build_s, untraced_best_s, traced_best_s,
    best_tracer, best_traced_report)``."""
    from nonlocalheatequation_torch.obs.trace import Tracer

    # a non-positive iter count would return inf walls and a None tracer
    # — always measure at least once
    iters = max(1, int(iters))

    def run_schedule(tracer):
        pipe = ServePipeline(engine=engine, depth=depth, window_ms=0.0,
                             tracer=tracer)
        try:
            t0 = time.perf_counter()
            pipe.serve_cases(cases)
            return time.perf_counter() - t0, pipe.report
        finally:
            pipe.close()

    compile_s, _ = run_schedule(Tracer())
    plain_best = float("inf")
    traced_best, best_tracer, best_rep = float("inf"), None, None
    for _ in range(iters):
        # TRACE_OFF, not None: the baseline must stay untraced even when
        # a process-global tracer is installed (--trace/NLHEAT_TRACE),
        # or the A/B would trace both arms and measure nothing
        sec_u, _ = run_schedule(obs_trace.TRACE_OFF)
        plain_best = min(plain_best, sec_u)
        tracer = Tracer()
        sec_t, rep = run_schedule(tracer)
        if sec_t < traced_best:
            traced_best, best_tracer, best_rep = sec_t, tracer, rep
    return compile_s, plain_best, traced_best, best_tracer, best_rep


def serve_chaos(engine: EnsembleEngine, cases, depth: int, plan_spec: str,
                *, retries: int = 2, fetch_deadline_ms: float = 2000.0,
                breaker_threshold: int = 1,
                breaker_cooldown_ms: float = 600_000.0):
    """The chaos measurement: serve ``cases`` through a fully supervised
    pipeline while the deterministic plan ``plan_spec`` (utils/faults.py
    grammar) injects faults mid-stream.  The default breaker opens on the
    FIRST device failure and stays open (10-minute cooldown), so any
    injected raise/stall fault guarantees at least one fallback-served
    chunk.  (A nan-only plan does NOT: corruption is data-shaped and
    deliberately never opens the breaker.)  Returns ``(wall_s, results,
    report)``; a quarantined case's results slot is None."""
    pipe = ServePipeline(
        engine=engine, depth=depth, window_ms=0.0,
        faults=FaultPlan.parse(plan_spec), retries=retries,
        fetch_deadline_ms=fetch_deadline_ms, backoff_ms=0.0,
        breaker=CircuitBreaker(threshold=breaker_threshold,
                               cooldown_ms=breaker_cooldown_ms))
    try:
        t0 = time.perf_counter()
        results = pipe.serve_cases(cases)
        return time.perf_counter() - t0, results, pipe.report
    finally:
        pipe.close()
