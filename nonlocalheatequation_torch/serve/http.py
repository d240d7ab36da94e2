"""HTTP ingestion tier: the fleet's front door, with admission control —
the port's copy of ``nonlocalheatequation_tpu/serve/http.py``.

obs/export.py proved the shape — a stdlib ThreadingHTTPServer on
127.0.0.1 serving process telemetry.  This module promotes that
machinery from telemetry to a REQUEST API over a serving backend (a
:class:`~nonlocalheatequation_torch.serve.router.ReplicaRouter`, or
anything with ``submit``/``outstanding_total``/``retry_after_s``):

* ``POST /v1/cases`` — submit one case.  Two forms:
  the EXPLICIT form (JSON body: ``shape``, ``nt``, ``eps``, ``k``,
  ``dt``, ``dh``, optional ``test``/``u0``/``deadline_ms``/
  ``priority``) runs the fleet's default engine at the caller's
  schedule; the PICKED form replaces ``nt``/``dt`` with ``T_final`` +
  ``accuracy`` (error_l2/#points target) and lets the engine picker
  (serve/picker.py) choose the cheapest stepper x stages x method x
  precision meeting accuracy — and ``deadline_ms``, which in this form
  also bounds the modeled compute.  Returns 202 ``{"id": N}`` (picked
  form adds the chosen ``engine``/``nt``/``dt`` evidence), **422**
  when no engine meets accuracy+deadline (the picker refuses loudly,
  never silently serves a miss), or **429 + Retry-After** when
  admission control sheds.
* ``GET /v1/cases/<id>`` — poll: ``{"status": "queued"|"done"|"failed"}``
  plus latency/replica detail; ``?wait=1`` (optional ``&timeout_s=T``)
  blocks until the case completes — the stream/wait form.
* ``GET /v1/cases/<id>/result`` — the solved state: JSON
  ``{"shape": ..., "values": [...]}`` by default (f64 round-trip-exact),
  or raw ``.npy`` bytes with ``?bin=1``.
* **Sessions** (serve/sessions.py — present when the server is built
  with a :class:`~nonlocalheatequation_torch.serve.sessions.SessionManager`;
  without one every session route answers 404):
  ``POST /v1/sessions`` opens a live simulation (case fields + ``nt``
  total steps + ``chunk_steps``/``preview_stride``/``budget_steps``/
  ``checkpoint_every``), 429-shedding exactly like cases;
  ``GET /v1/sessions/<id>`` is the status+audit document;
  ``GET /v1/sessions/<id>/stream[?from_step=N]`` streams frames as
  Server-Sent Events (``data: {...}\\n\\n`` per chunk boundary — coarse
  f32 previews, then the final full-f64 frame; the ``from_step``
  cursor makes a reconnect lossless and duplicate-free);
  ``POST /v1/sessions/<id>/retarget`` queues a mid-flight source/k
  change (applied at the next chunk boundary, step recorded);
  ``POST /v1/sessions/<id>/fork`` branches a what-if session from a
  checkpoint; ``POST /v1/sessions/<id>/close`` ends the stream;
  ``GET /v1/sessions/<id>/result`` fetches the final f64 field
  (``?bin=1`` for raw .npy bytes).
* **Meshes** (serve/meshes.py — present when a mesh registry
  is configured via ``mesh_dir`` or ``NLHEAT_MESH_DIR``):
  ``POST /v1/meshes`` uploads a point cloud ONCE (JSON ``points`` +
  ``eps`` field + optional ``vol``; validated + bounded — an oversized
  or malformed body is a loud 400 — then content-hashed and persisted),
  returning ``{"hash", "nodes", "dim", "edges"}``; cases and sessions
  then reference it with ``"mesh": <hash>`` INSTEAD of
  ``shape``/``eps``/``dh`` (the registered cloud carries the geometry),
  which routes the mesh's bucket sticky and warm-boots its compiled
  gather program's recipe from the shared program store (serve/ensemble.py).
  ``GET /v1/meshes/<hash>`` returns the stored mesh's metadata.
* ``GET /healthz`` — liveness + fleet summary.
* ``GET /v1/status`` — the one-page fleet health document:
  replica liveness/breakers/staleness, admission counters, sessions,
  and the SLO ledger's burn/drift block when auditing is on.
* ``GET /metrics`` / ``/metrics.json`` — the backend registry's
  Prometheus/JSON exposition (the router's registry already aggregates
  per-replica namespaces; obs/export.py renders it).

**Admission control** (:class:`AdmissionController`) sheds BEFORE the
pipe collapses, keyed off the gauges already in the metrics registry:
the in-flight depth (``/router/outstanding`` vs the bounded
``max_pending`` budget) and the observed queue-wait/latency window
(``/router/request-latency-ms``).  A shed is a 429 with a Retry-After
computed from the observed p50 service time — never an unbounded queue,
never a silent drop.  The router's own hard bound
(:class:`~nonlocalheatequation_torch.serve.router.RouterOverloaded`)
backstops it: admission is the soft gate, the router cap the hard one,
and both surface as 429.

Bind address is 127.0.0.1 only, like the metrics endpoint: this tier
terminates trusted localhost traffic (a reverse proxy owns the wire).
"""

from __future__ import annotations

import io
import json
import threading
import time

import numpy as np

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.export import (
    merged_prometheus,
    merged_snapshot_json,
)
from nonlocalheatequation_torch.obs.trace import TraceContext
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase
from nonlocalheatequation_torch.serve.meshes import (
    MAX_BODY_BYTES as MESH_MAX_BODY_BYTES,
    UnknownMesh,
    resolve_mesh_store,
)
from nonlocalheatequation_torch.serve.picker import PickerRefusal, pick_engine
from nonlocalheatequation_torch.serve.router import RouterOverloaded

#: Completed requests retained for polling (an abandoned client must not
#: grow the ingress's memory without bound): the most recent RESULTS_CAP
#: finished cases stay fetchable, older ones age out (410 Gone).
RESULTS_CAP = 4096

#: Default wait bound for ``?wait=1`` (a handler thread parked forever
#: on an abandoned connection is a slot leak).
WAIT_TIMEOUT_S = 300.0


class AdmissionController:
    """The soft gate in front of the router's hard in-flight cap.

    ``max_pending`` bounds the admitted-but-unfinished depth (default:
    the backend's own ``max_outstanding`` per live replica — admission
    then sheds exactly where the router would refuse, one request
    earlier and politely).  ``max_queue_wait_ms`` additionally sheds
    while the observed p50 request latency exceeds it — the queue-wait
    form of the same promise: a request we cannot serve inside the
    bound is refused NOW with a retry hint, not parked.

    The SESSION tier's fleet-wide gate lives here too (serve/sessions.py):
    ``session_steps_per_s`` rate-limits the
    aggregate step rate streaming sessions may draw (a token bucket on
    the injected ``clock``; burst = one second's tokens), and every
    session chunk additionally clears :meth:`check` — so a saturated
    batch tier DEFERS session chunks and a greedy session can never
    starve the batch tier.  A refused chunk is a deferral the session
    manager retries at its next pump, never an error.

    Counters land in the backend registry: ``/ingress/accepted``,
    ``/ingress/shed``, the ``/ingress/retry-after-s`` gauge (the most
    recent hint), and the session gate's ``/ingress/session-steps`` /
    ``/ingress/session-deferred``."""

    def __init__(self, backend, *, max_pending: int | None = None,
                 max_queue_wait_ms: float | None = None,
                 session_steps_per_s: float | None = None,
                 session_burst_steps: float | None = None,
                 clock=time.monotonic):
        self.backend = backend
        self.max_pending = max_pending
        self.max_queue_wait_ms = max_queue_wait_ms
        r = backend.registry
        self._m_accepted = r.counter("/ingress/accepted")
        self._m_shed = r.counter("/ingress/shed")
        self._m_retry_after = r.gauge("/ingress/retry-after-s")
        # the session gate's token bucket (0/None = no rate cap; the
        # batch-depth check still applies to session chunks).  The
        # burst defaults to one second's tokens; session_burst_steps
        # pins it explicitly (a benchmark pins one CHUNK so the gate
        # engages at any scale, not only past the first second)
        if session_steps_per_s is not None and session_steps_per_s < 0:
            raise ValueError(
                f"session_steps_per_s must be >= 0, got "
                f"{session_steps_per_s}")
        if session_burst_steps is not None and session_burst_steps <= 0:
            raise ValueError(
                f"session_burst_steps must be > 0, got "
                f"{session_burst_steps}")
        self._clock = clock
        self.session_steps_per_s = (float(session_steps_per_s)
                                    if session_steps_per_s else None)
        self._session_cap = (float(session_burst_steps)
                             if session_burst_steps is not None
                             else self.session_steps_per_s or 0.0)
        # the bucket is mutated from every pumping thread (the session
        # manager's driver, drive() callers, stream() reader threads) —
        # an unlocked read-modify-write would lose chunk debt and admit
        # above the configured rate
        self._session_lock = threading.Lock()
        self._session_tokens = self._session_cap  # guarded_by: self._session_lock
        self._session_t = clock()  # guarded_by: self._session_lock
        self._m_session_steps = r.counter("/ingress/session-steps")
        self._m_session_deferred = r.counter("/ingress/session-deferred")

    def _cap(self) -> int:
        if self.max_pending is not None:
            return int(self.max_pending)
        return self.backend.max_outstanding * max(
            1, self.backend.live_count())

    def check(self) -> float | None:
        """None to admit, else the Retry-After hint in seconds."""
        pending = self.backend.outstanding_total()
        if pending >= self._cap():
            return self._hint(pending)
        if self.max_queue_wait_ms is not None:
            pct = self.backend.registry.get(
                "/router/request-latency-ms")
            p50 = (pct.percentiles().get("p50", 0.0)
                   if pct is not None else 0.0)
            if p50 > self.max_queue_wait_ms:
                return self._hint(pending)
        return None

    def admit_session(self, steps: int) -> float | None:
        """None to admit one session chunk of ``steps``, else the
        defer hint in seconds.  Order matters: the batch-depth check
        first (a saturated fleet defers sessions regardless of
        tokens), then the rate bucket.  Tokens may go negative on an
        oversized chunk — the debt throttles later chunks, so the
        AVERAGE rate holds even when chunk_steps exceeds one window."""
        retry = self.check()
        if retry is not None:
            self._m_session_deferred.inc()
            return retry
        if self.session_steps_per_s:
            now = self._clock()
            cap = self._session_cap
            with self._session_lock:
                self._session_tokens = min(
                    cap, self._session_tokens
                    + (now - self._session_t) * self.session_steps_per_s)
                self._session_t = now
                if self._session_tokens < min(float(steps), cap):
                    short = min(float(steps), cap) - self._session_tokens
                    self._m_session_deferred.inc()
                    return max(0.05, short / self.session_steps_per_s)
                self._session_tokens -= float(steps)
        self._m_session_steps.inc(int(steps))
        return None

    def _hint(self, pending: int) -> float:
        hint = self.backend.retry_after_s()
        # a deep backlog needs more than one service time to clear
        hint *= max(1.0, pending / max(1, self._cap()))
        self._m_retry_after.set(round(hint, 3))
        return hint

    def try_submit(self, case: EnsembleCase, *, deadline_ms=None,
                   priority: int = 0, trace=None, engine=None):
        """``(request, None)`` when admitted, ``(None, retry_after_s)``
        when shed (by this gate or the router's hard cap).  ``trace``
        (a TraceContext) and ``engine`` (a picked
        :class:`~nonlocalheatequation_torch.serve.picker.EngineChoice`)
        are forwarded to the backend only when present, so plain
        callers and router-shaped stubs are untouched."""
        retry = self.check()
        if retry is not None:
            self._m_shed.inc()
            return None, retry
        kw = {"trace": trace} if trace is not None else {}
        if engine is not None:
            kw["engine"] = engine
        try:
            req = self.backend.submit(case, deadline_ms=deadline_ms,
                                      priority=priority, **kw)
        except RouterOverloaded as e:
            self._m_shed.inc()
            self._m_retry_after.set(round(e.retry_after_s, 3))
            return None, e.retry_after_s
        self._m_accepted.inc()
        return req, None


def parse_case(body: dict, meshes=None) -> EnsembleCase:
    """Validate one JSON case body into an EnsembleCase — loudly: a
    malformed submission is the CLIENT's 400, never a worker's stack
    trace mid-chunk.

    ``meshes`` (a serve/meshes.py MeshStore, or None when no registry
    is configured) resolves mesh-keyed bodies: ``"mesh":
    <hash>`` REPLACES ``shape``/``eps``/``dh`` — the registered cloud
    carries the geometry, so shape becomes the node count ``(n,)`` and
    eps/dh ride as 0 (the EnsembleCase mesh semantics).  An unknown
    hash raises :class:`~nonlocalheatequation_torch.serve.meshes.UnknownMesh`
    (the HTTP layer's 404); a malformed one is the usual ValueError."""
    try:
        mhash = body.get("mesh")
        if mhash is not None:
            if not isinstance(mhash, str):
                raise ValueError(f"mesh must be a hash string, got "
                                 f"{type(mhash).__name__}")
            if meshes is None:
                raise ValueError(
                    "mesh-keyed case but no mesh registry on this "
                    "server (NLHEAT_MESH_DIR off)")
            for clash in ("shape", "eps", "dh"):
                if clash in body:
                    raise ValueError(
                        f"a mesh-keyed case carries its geometry in the "
                        f"registered cloud: drop {clash!r}")
            meta = meshes.meta(mhash)  # ValueError | UnknownMesh
            shape = (int(meta["nodes"]),)
            nt = int(body["nt"])
            if nt < 1:
                raise ValueError(f"need nt >= 1 (got {nt})")
            case = EnsembleCase(
                shape=shape, nt=nt, eps=0, k=float(body["k"]),
                dt=float(body["dt"]), dh=0.0,
                test=bool(body.get("test", False)), mesh=mhash)
        else:
            shape = tuple(int(s) for s in body["shape"])
            if not 1 <= len(shape) <= 3 or any(s < 1 for s in shape):
                raise ValueError(f"bad shape {shape}")
            nt = int(body["nt"])
            eps = int(body["eps"])
            if nt < 1 or eps < 1:
                raise ValueError(
                    f"need nt >= 1 and eps >= 1 (got {nt}, {eps})")
            case = EnsembleCase(
                shape=shape, nt=nt, eps=eps, k=float(body["k"]),
                dt=float(body["dt"]), dh=float(body["dh"]),
                test=bool(body.get("test", False)))
        deadline = body.get("deadline_ms")
        if deadline is not None:
            if not isinstance(deadline, (int, float)) or deadline < 0:
                raise ValueError(
                    f"deadline_ms must be a number >= 0, got {deadline!r}")
        prio = body.get("priority", 0)
        if not isinstance(prio, int) or isinstance(prio, bool):
            raise ValueError(f"priority must be an integer, got {prio!r}")
        u0 = body.get("u0")
        if u0 is not None:
            u0 = np.asarray(u0, np.float64)
            if u0.size != int(np.prod(shape)):
                raise ValueError(
                    f"u0 has {u0.size} values, shape {shape} needs "
                    f"{int(np.prod(shape))}")
            case.u0 = u0.reshape(shape)
        elif not case.test:
            raise ValueError("a production (test=false) case needs u0")
        return case
    except UnknownMesh:
        raise  # the 404, not a missing-field 400
    except KeyError as e:
        raise ValueError(f"missing case field {e.args[0]!r}") from None


class IngressServer:
    """The front door: HTTP request API over a router, 127.0.0.1 only.

    ``backend`` is the ReplicaRouter (owned by the caller — the server
    never closes it); ``admission`` defaults to an
    :class:`AdmissionController` with the router-cap budget.  ``port``
    0 picks a free port (the resolved one is ``self.port``)."""

    def __init__(self, port: int, backend, *,
                 admission: AdmissionController | None = None,
                 max_pending: int | None = None,
                 max_queue_wait_ms: float | None = None,
                 sessions=None, mesh_dir: str | None = None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.backend = backend
        #: mesh registry root (serve/meshes.py): an explicit dir, or
        #: None = the ambient NLHEAT_MESH_DIR knob (resolved per
        #: request so tests and soak rigs can point it late); when both
        #: are off the mesh endpoints 404
        self.mesh_dir = mesh_dir
        self.admission = admission if admission is not None else \
            AdmissionController(backend, max_pending=max_pending,
                                max_queue_wait_ms=max_queue_wait_ms)
        #: the session tier (serve/sessions.py SessionManager), owned by
        #: the caller like the backend; None = session endpoints 404
        self.sessions = sessions
        self._requests: dict[int, object] = {}
        self._done: dict[int, None] = {}  # insertion-ordered: FIFO aging
        self._lock = threading.Lock()
        ingress = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json",
                       headers=()) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj, headers=()) -> None:
                self._reply(code, (json.dumps(obj) + "\n").encode(),
                            headers=headers)

            def do_POST(self):  # noqa: N802 — http.server API
                try:
                    ingress._post(self)
                except Exception as e:  # noqa: BLE001 — a request must
                    # not kill the server; the client gets the 500
                    try:
                        self._json(500, {"error": f"{type(e).__name__}: "
                                                  f"{e}"})
                    except Exception:  # noqa: BLE001
                        pass

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    ingress._get(self)
                except Exception as e:  # noqa: BLE001
                    try:
                        self._json(500, {"error": f"{type(e).__name__}: "
                                                  f"{e}"})
                    except Exception:  # noqa: BLE001
                        pass

            def log_message(self, *a):  # silence per-request chatter
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="nlheat-ingress")
        self._thread.start()

    def _tracer(self):
        """The ingress's span tracer: the backend router's (same
        process, merged into the fleet timeline) or the ambient global
        one.  None when tracing is off — one attribute read."""
        tr = getattr(self.backend, "_tracer", None)
        return tr if tr is not None else obs_trace.get_tracer()

    def _meshes(self):
        """The mesh registry (serve/meshes.py MeshStore), or None when
        neither ``mesh_dir`` nor ``NLHEAT_MESH_DIR`` configures one."""
        return resolve_mesh_store(self.mesh_dir)

    # -- request handling (called from handler threads) ----------------------
    def _post(self, h) -> None:
        path = h.path.rstrip("/")
        if path == "/v1/sessions" or path.startswith("/v1/sessions/"):
            self._post_session(h, path)
            return
        if path == "/v1/meshes":
            self._post_mesh(h)
            return
        if path != "/v1/cases":
            h._json(404, {"error": f"no such endpoint {h.path!r}"})
            return
        # trace identity: adopt the client's X-NLHEAT-Trace
        # header or, when tracing is on, mint one HERE — the ingress is
        # the trace root every downstream span chains to
        tr = self._tracer()
        hdr = h.headers.get("X-NLHEAT-Trace")
        ctx = TraceContext.from_header(hdr) if hdr else None
        if ctx is None and tr is not None:
            ctx = TraceContext.mint()
        t0 = time.monotonic() if tr is not None else 0.0
        try:
            n = int(h.headers.get("Content-Length") or 0)
            body = json.loads(h.rfile.read(n).decode() or "{}")
            if not isinstance(body, dict):
                raise ValueError(
                    f"case body must be a JSON object, got "
                    f"{type(body).__name__}")
            case, picked = self._parse_body(body)
        except PickerRefusal as e:
            # no engine meets accuracy+deadline: the request's contract
            # is unservable — a client 422 naming the best infeasible
            # candidate, never a silently-slow or silently-wrong solve
            h._json(422, {"error": str(e), "refused": "picker"})
            return
        except UnknownMesh as e:
            h._json(404, {"error": str(e)})
            return
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            h._json(400, {"error": str(e)})
            return
        req, retry = self.admission.try_submit(
            case, deadline_ms=body.get("deadline_ms"),
            priority=body.get("priority") or 0, trace=ctx,
            engine=picked)
        if req is None:
            if tr is not None and ctx is not None:
                tr.instant("ingress.shed", cat="ingress",
                           trace=ctx.trace_id,
                           retry_after_s=round(retry, 3))
            h._json(429, {"error": "overloaded",
                          "retry_after_s": round(retry, 3)},
                    headers=[("Retry-After",
                              str(max(1, int(np.ceil(retry)))))])
            return
        with self._lock:
            self._requests[req.seq] = req
        self._sweep()
        headers = []
        if ctx is not None:
            if ctx.request is None:
                ctx.request = req.seq
            headers.append(("X-NLHEAT-Trace", ctx.to_header()))
            if tr is not None:
                # the trace ROOT: one ingress span over parse+admit+
                # route, plus the flow START the router/worker chain
                # hangs off (flow events tie the pids together)
                now = time.monotonic()
                tr.flow("request", "start", ctx.trace_id, ts=t0,
                        cat="ingress", req=req.seq)
                tr.complete("ingress.request", t0, now, cat="ingress",
                            trace=ctx.trace_id, req=req.seq,
                            replica=req.replica)
        resp = {"id": req.seq, "status": "queued"}
        if picked is not None:
            # the pick's evidence: which engine serves the case and the
            # schedule it chose — auditable, never a black box
            resp["engine"] = picked.wire()
            resp["nt"] = picked.steps
            resp["dt"] = picked.dt
        if ctx is not None:
            resp["trace"] = ctx.trace_id
        h._json(202, resp, headers=headers)

    def _parse_body(self, body: dict):
        """Both POST forms (module docstring): returns ``(case,
        picked)`` — picked None for the explicit nt/dt form.  The
        picked form routes accuracy/T_final through the engine picker
        with the fleet's engine base and, for a case bound for the
        sharded tier, the router's sharded-fft capability verdict as
        the fft candidate axis (ops/spectral_sharded.py — the pencil
        transform serves compatible (grid, mesh) pairs; incompatible
        ones pick on the stencil axis)."""
        meshes = self._meshes()
        if "accuracy" not in body and "T_final" not in body:
            return parse_case(body, meshes=meshes), None
        for bad in ("nt", "dt"):
            if bad in body:
                raise ValueError(
                    f"a picked-engine case names the contract "
                    f"(T_final + accuracy), not the schedule: drop "
                    f"{bad!r} — the picker chooses dt/steps — or drop "
                    "accuracy/T_final for the explicit form")
        for need in ("accuracy", "T_final"):
            if need not in body:
                raise ValueError(
                    f"the picked form needs both T_final and accuracy "
                    f"(missing {need!r})")
        # validate every NON-schedule field through parse_case first
        # (placeholder schedule): ONE validator, shared with the
        # explicit form verbatim — missing fields, bad-rank shapes,
        # eps < 1, u0/test rules are all the client's 400 here too
        base = {k2: v for k2, v in body.items()
                if k2 not in ("accuracy", "T_final")}
        parse_case(base | {"nt": 1, "dt": 1.0}, meshes=meshes)
        if body.get("mesh") is not None:
            # the MESH axis: geometry and the stability
            # bound come from the registered cloud (serve/picker.py
            # _pick_mesh_engine); the grid shape/eps/dh knobs are
            # absent by the parse_case mesh contract, so the
            # placeholders below are ignored by the picker
            T_final = float(body["T_final"])
            accuracy = float(body["accuracy"])
            picked = pick_engine(
                (1,), 1, float(body["k"]), 1.0, T_final, accuracy,
                deadline_ms=body.get("deadline_ms"),
                mesh=str(body["mesh"]), mesh_dir=self.mesh_dir)
            case = parse_case(base | {"nt": picked.steps,
                                      "dt": picked.dt}, meshes=meshes)
            return case, picked
        shape = tuple(int(s) for s in body["shape"])
        eps = int(body["eps"])
        k = float(body["k"])
        dh = float(body["dh"])
        if not dh > 0:
            # the one rule the explicit form has no stake in: the
            # picker's stability constant divides by (eps*dh)
            raise ValueError(f"dh must be > 0, got {dh}")
        T_final = float(body["T_final"])
        accuracy = float(body["accuracy"])
        # T_final/accuracy/deadline_ms positivity: pick_engine's own
        # refusals (ValueError -> the client's 400)
        # the ROUTER's own predicates (one rule, no drift): a case the
        # router would route to the gang picks on the fft axis only
        # when the router's sharded-fft capability says the pencil
        # transform can serve it; router-shaped stubs without the predicates are
        # never sharded / never fft-capable
        is_sharded = getattr(self.backend, "is_sharded", None)
        sharded = bool(is_sharded(shape)) if is_sharded else False
        cap = getattr(self.backend, "sharded_fft_capability", None)
        allow_fft = (not sharded) or bool(cap and cap(shape, eps))
        ek = getattr(self.backend, "engine_kwargs", None) or {}
        picked = pick_engine(
            shape, eps, k, dh, T_final, accuracy,
            deadline_ms=body.get("deadline_ms"),
            method=ek.get("method", "auto"), allow_fft=allow_fft)
        case = parse_case(base | {"nt": picked.steps, "dt": picked.dt},
                          meshes=meshes)
        return case, picked

    # -- the mesh registry (serve/meshes.py) ---------------------------------
    def _post_mesh(self, h) -> None:
        """``POST /v1/meshes``: validate + hash + persist one point
        cloud.  The read is BOUNDED (serve/meshes.py MAX_BODY_BYTES) —
        an oversized declared body is refused before a byte of it is
        read, and every validation failure is the client's 400."""
        store = self._meshes()
        if store is None:
            h._json(404, {"error": "no mesh registry on this server "
                                   "(serve/meshes.py — set mesh_dir or "
                                   "NLHEAT_MESH_DIR)"})
            return
        n = int(h.headers.get("Content-Length") or 0)
        if n > MESH_MAX_BODY_BYTES:
            h._json(400, {"error": f"mesh upload declares {n} bytes, "
                                   f"over the {MESH_MAX_BODY_BYTES}-"
                                   "byte cap"})
            return
        try:
            body = json.loads(h.rfile.read(n).decode() or "{}")
            if not isinstance(body, dict):
                raise ValueError(
                    f"mesh body must be a JSON object, got "
                    f"{type(body).__name__}")
            for need in ("points", "eps"):
                if need not in body:
                    raise ValueError(
                        f"a mesh upload needs {need!r} (points + eps "
                        "field + optional vol)")
            mhash = store.put(body["points"], body["eps"],
                              body.get("vol"))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            h._json(400, {"error": str(e)})
            return
        h._json(201, store.meta(mhash))

    def _get_mesh(self, h, path: str) -> None:
        store = self._meshes()
        if store is None:
            h._json(404, {"error": "no mesh registry on this server"})
            return
        mhash = path[len("/v1/meshes/"):]
        try:
            h._json(200, store.meta(mhash))
        except UnknownMesh as e:
            h._json(404, {"error": str(e)})
        except ValueError as e:
            h._json(400, {"error": str(e)})

    # -- the session tier (serve/sessions.py) --------------------------------
    def _read_body(self, h) -> dict:
        n = int(h.headers.get("Content-Length") or 0)
        body = json.loads(h.rfile.read(n).decode() or "{}")
        if not isinstance(body, dict):
            raise ValueError(
                f"body must be a JSON object, got {type(body).__name__}")
        return body

    def _post_session(self, h, path: str) -> None:
        if self.sessions is None:
            h._json(404, {"error": "no session tier on this server "
                                   "(serve/sessions.py SessionManager "
                                   "not configured)"})
            return
        if path == "/v1/sessions":
            self._open_session(h)
            return
        rest = path[len("/v1/sessions/"):]
        sid, _, verb = rest.partition("/")
        try:
            body = self._read_body(h)
            if verb == "retarget":
                out = self.sessions.retarget(
                    sid, k=body.get("k"), source=body.get("source"),
                    clear_source=bool(body.get("clear_source")))
                h._json(202, dict(out, session=sid))
            elif verb == "fork":
                child = self.sessions.fork(sid, step=body.get("step"))
                h._json(201, {"session": child.sid,
                              "parent": sid,
                              "from_step": child.step})
            elif verb == "close":
                h._json(200, self.sessions.close_session(sid))
            else:
                h._json(404, {"error": f"no session verb {verb!r}"})
        except KeyError as e:
            h._json(404, {"error": str(e.args[0]) if e.args else str(e)})
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            h._json(400, {"error": str(e)})

    def _open_session(self, h) -> None:
        from nonlocalheatequation_torch.serve.sessions import SessionSpec

        try:
            body = self._read_body(h)
            # ONE validator with the case form: every shared field
            # (shape/eps/k/dh rules, u0 size, production-needs-u0)
            # refuses exactly as POST /v1/cases would; nt is the
            # session's TOTAL steps
            case = parse_case({k2: v for k2, v in body.items()
                               if k2 in ("shape", "nt", "eps", "k", "dt",
                                         "dh", "u0", "test", "mesh")},
                              meshes=self._meshes())
            if case.test:
                raise ValueError(
                    "sessions are production solves (test=false with "
                    "u0); the manufactured-source test path cannot be "
                    "chunked")
            spec = SessionSpec(
                shape=case.shape, eps=case.eps, k=case.k, dt=case.dt,
                dh=case.dh, u0=case.u0, nt=case.nt, mesh=case.mesh,
                chunk_steps=int(body.get("chunk_steps",
                                         self.sessions.default_chunk_steps)),
                preview_stride=body.get("preview_stride"),
                budget_steps=body.get("budget_steps"),
                checkpoint_every=body.get("checkpoint_every"))
        except UnknownMesh as e:
            h._json(404, {"error": str(e)})
            return
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            h._json(400, {"error": str(e)})
            return
        # open-admission mirrors case admission: a saturated fleet
        # sheds the OPEN (429 + Retry-After); a live session's chunks
        # then defer through the session gate instead of shedding
        retry = self.admission.check()
        if retry is not None:
            h._json(429, {"error": "overloaded",
                          "retry_after_s": round(retry, 3)},
                    headers=[("Retry-After",
                              str(max(1, int(np.ceil(retry)))))])
            return
        try:
            s = self.sessions.open(spec)
        except (ValueError, TypeError, RuntimeError) as e:
            h._json(400, {"error": str(e)})
            return
        h._json(201, {"session": s.sid, "status": "running",
                      "step": s.step, "nt": spec.nt,
                      "chunk_steps": spec.chunk_steps,
                      "stream": f"/v1/sessions/{s.sid}/stream"})

    def _get_session(self, h, path: str, params: dict) -> None:
        if self.sessions is None:
            h._json(404, {"error": "no session tier on this server"})
            return
        rest = path[len("/v1/sessions/"):]
        sid, _, verb = rest.partition("/")
        try:
            s = self.sessions.get(sid)
        except KeyError:
            h._json(404, {"error": f"no live session {sid!r}"})
            return
        if verb == "":
            h._json(200, s.status())
            return
        if verb == "result":
            out = s.result()
            if out is None:
                h._json(409, {"error": f"session {sid!r} is "
                                       f"{s.status()['state']}; the "
                                       "final field exists once done/"
                                       "closed"})
                return
            if params.get("bin") in ("1", "true"):
                bio = io.BytesIO()
                np.save(bio, out)
                h._reply(200, bio.getvalue(),
                         ctype="application/octet-stream")
            else:
                h._json(200, {"session": sid,
                              "step": s.status()["step"],
                              "shape": list(out.shape),
                              "values": out.ravel().tolist()})
            return
        if verb != "stream":
            h._json(404, {"error": f"no session endpoint {verb!r}"})
            return
        try:
            from_step = int(params.get("from_step", -1))
            timeout = float(params.get("timeout_s") or WAIT_TIMEOUT_S)
        except ValueError:
            h._json(400, {"error": "bad from_step/timeout_s"})
            return
        # Server-Sent Events over a close-delimited HTTP/1.1 response:
        # no Content-Length, so the connection closes when the stream
        # ends — every frame is one `data:` line, flushed immediately
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-store")
        h.send_header("Connection", "close")
        h.end_headers()
        try:
            for fr in self.sessions.stream(sid, from_step=from_step,
                                           timeout_s=timeout):
                h.wfile.write(b"data: " + json.dumps(fr.wire()).encode()
                              + b"\n\n")
                h.wfile.flush()
            h.wfile.write(b"event: end\ndata: " +
                          json.dumps(s.status()).encode() + b"\n\n")
            h.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # the client hung up: its cursor makes reconnect lossless
        finally:
            h.close_connection = True

    def _get(self, h) -> None:
        path, _, query = h.path.partition("?")
        params = {}
        for kv in query.split("&"):
            if "=" in kv:
                k, _, v = kv.partition("=")
                params[k] = v
        if path.startswith("/v1/sessions/"):
            self._get_session(h, path.rstrip("/"), params)
            return
        if path.startswith("/v1/meshes/"):
            self._get_mesh(h, path.rstrip("/"))
            return
        if path == "/healthz":
            m = self.backend.metrics()
            body = {"ok": m["replicas"] > 0,
                    "replicas": m["replicas"],
                    "outstanding": m["outstanding"],
                    "deaths": m["deaths"]}
            # fleet-shape evidence: which transport the
            # workers speak and whether the sharded big-case tier is
            # up (router-shaped stubs without the fields stay valid)
            if m.get("transport") is not None:
                body["transport"] = m["transport"]
            if m.get("shard_threshold") is not None:
                body["gang"] = len(m.get("gang") or [])
                body["sharded_cases"] = m.get("sharded_cases", 0)
            if self.sessions is not None:
                # session-tier liveness rides the same health document
                body["sessions"] = self.sessions._active_count()
            h._json(200, body)
            return
        if path == "/v1/status":
            self._get_status(h)
            return
        if path.startswith("/metrics"):
            regs = [self.backend.registry]
            if path.startswith("/metrics.json"):
                h._reply(200, merged_snapshot_json(regs).encode())
            else:
                h._reply(200, merged_prometheus(regs).encode(),
                         ctype="text/plain; version=0.0.4")
            return
        if not path.startswith("/v1/cases/"):
            h._json(404, {"error": f"no such endpoint {path!r}"})
            return
        rest = path[len("/v1/cases/"):]
        want_result = rest.endswith("/result")
        if want_result:
            rest = rest[:-len("/result")]
        try:
            seq = int(rest)
        except ValueError:
            h._json(400, {"error": f"bad case id {rest!r}"})
            return
        with self._lock:
            req = self._requests.get(seq)
        if req is None:
            h._json(410 if seq < self.backend.metrics()["cases"] else 404,
                    {"error": f"case {seq} unknown or aged out"})
            return
        if params.get("wait") in ("1", "true"):
            try:
                timeout = float(params.get("timeout_s") or WAIT_TIMEOUT_S)
            except ValueError:
                h._json(400, {"error": f"bad timeout_s "
                                       f"{params.get('timeout_s')!r}"})
                return
            req.done.wait(timeout)
        if not req.done.is_set():
            h._json(200, {"id": seq, "status": "queued",
                          "replica": req.replica})
            return
        self._note_done(seq)
        if req.error is not None:
            h._json(200 if not want_result else 409, {
                "id": seq, "status": "failed",
                "classification": getattr(req.error, "classification",
                                          "error"),
                "error": str(req.error)})
            return
        if not want_result:
            h._json(200, {"id": seq, "status": "done",
                          "replica": req.replica,
                          "requeues": req.requeues,
                          "latency_s": round(req.latency_s or 0.0, 6)})
            return
        if params.get("bin") in ("1", "true"):
            bio = io.BytesIO()
            np.save(bio, req.result)
            h._reply(200, bio.getvalue(),
                     ctype="application/octet-stream")
        else:
            h._json(200, {"id": seq,
                          "shape": list(req.result.shape),
                          "values": req.result.ravel().tolist()})

    def _get_status(self, h) -> None:
        """``GET /v1/status``: the one-page fleet health document
        — replica liveness/draining/breaker/scrape-staleness,
        in-flight accounting, ingress admission counters, the session
        tier, and the SLO block (burn, drift, per-axis hit rates) when
        the ledger is on.  Assembled from state this process ALREADY
        holds (backend metrics, the registry, each replica's last
        absorbed stats frame) — a status poll never broadcasts to the
        fleet, so dashboards can hammer it.  Router-shaped stubs and
        plain pipelines stay valid: every field is read defensively."""
        m = self.backend.metrics()
        reg = getattr(self.backend, "registry", None)

        def metric(name):
            try:
                g = reg.get(name) if reg is not None else None
                return g.value if g is not None else None
            except Exception:  # noqa: BLE001 — status must render
                return None

        body = {
            "ok": (m.get("replicas") or 0) > 0 or "replicas" not in m,
            "replicas": m.get("replicas"),
            "gang": len(m.get("gang") or []),
            "transport": m.get("transport"),
            "cases": m.get("cases"),
            "outstanding": m.get("outstanding"),
            "deaths": m.get("deaths", 0),
            "requeued": m.get("requeued", 0),
            "spawns": m.get("spawns", 0),
            "scale_ups": m.get("scale_ups", 0),
            "scale_downs": m.get("scale_downs", 0),
            "buckets": m.get("buckets"),
            "request_latency_ms": m.get("request_latency_ms") or {},
            "ingress": {
                "accepted": metric("/ingress/accepted"),
                "shed": metric("/ingress/shed"),
                "retry_after_s": metric("/ingress/retry-after-s"),
                "session_steps": metric("/ingress/session-steps"),
                "session_deferred": metric("/ingress/session-deferred"),
            },
        }
        # per-replica rows: the router's routing view, the scrape
        # staleness label, and the breaker state from the
        # replica's last absorbed stats frame (no new pull)
        reps = getattr(self.backend, "_replicas", None) or {}
        per = {}
        for rid, info in (m.get("per_replica") or {}).items():
            row = dict(info)
            stale = metric(f"/replica{{{rid}}}/stale")
            if stale is not None:
                row["stale"] = bool(stale)
            frame = getattr(reps.get(rid), "last_stats", None) or {}
            br = (frame.get("metrics") or {}).get("breaker") or {}
            if br:
                row["breaker"] = {
                    "state": br.get("state"),
                    "transitions": br.get("transition_count"),
                }
            per[str(rid)] = row
        if per:
            body["per_replica"] = per
        if self.sessions is not None:
            body["sessions"] = self.sessions._active_count()
        if m.get("slo") is not None:
            body["slo"] = m["slo"]
        h._json(200, body)

    def _note_done(self, seq: int) -> None:
        """Age out old completed requests (bounded retention)."""
        with self._lock:
            self._done.setdefault(seq, None)
            while len(self._done) > RESULTS_CAP:
                old = next(iter(self._done))
                del self._done[old]
                self._requests.pop(old, None)

    def _sweep(self) -> None:
        """Move every completed-but-unnoted request into the bounded
        done window — called on each submission, so a fire-and-forget
        client that POSTs and never polls cannot grow ``_requests``
        without bound (the RESULTS_CAP promise holds without relying on
        anyone fetching).  O(retained), all bounded."""
        with self._lock:
            done = [seq for seq, req in self._requests.items()
                    if req.done.is_set() and seq not in self._done]
        for seq in done:
            self._note_done(seq)

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def offered_load_run(admission: AdmissionController, cases, rate_hz: float,
                     *, clock=time.monotonic, sleep=time.sleep) -> dict:
    """Offer ``cases`` at a fixed rate through the admission gate and
    account the outcome — the measurement loop of the router's load A/B
    (serve/router.py ``router_load_ab``)
    (the overload-honesty half: at an offered rate past capacity the
    gate must shed with hints, the accepted requests must still finish,
    and nothing may queue without bound).  Returns accepted/shed counts,
    the accepted requests' latency percentiles, the max observed
    in-flight depth, and the wall."""
    backend = admission.backend
    cases = list(cases)
    interval = 1.0 / rate_hz if rate_hz > 0 else 0.0
    accepted, shed = [], 0
    max_pending = 0
    t0 = clock()
    next_t = t0
    for case in cases:
        now = clock()
        if interval and now < next_t:
            sleep(next_t - now)
        next_t += interval
        req, _retry = admission.try_submit(case)
        if req is None:
            shed += 1
        else:
            accepted.append(req)
        max_pending = max(max_pending, backend.outstanding_total())
    for req in accepted:
        req.done.wait()
    wall = clock() - t0
    lat = sorted(r.latency_s for r in accepted if r.latency_s is not None)

    def pct(p):
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(p * (len(lat) - 1)))]

    return {
        "offered": len(cases),
        "accepted": len(accepted),
        "shed": shed,
        "max_pending": max_pending,
        "wall_s": wall,
        "latency_s": {"p50": pct(0.50), "p90": pct(0.90),
                      "p99": pct(0.99)},
        "results": [r.result for r in accepted],
    }
