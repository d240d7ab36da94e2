"""Live simulation sessions: a stateful streaming tier over the front door
— the port's copy of ``nonlocalheatequation_tpu/serve/sessions.py``.

Everything else the fleet serves is one-shot: submit a case, poll a result
(serve/http.py).  A SESSION is the interactive shape: a user holds a
simulation open, watches the field evolve as a stream of frames, steers
the source mid-flight, forks what-if branches, and survives replica death
without noticing.  The physics permits the steering: the reference's
source term ``b(t,x)`` is time-dependent, so a piecewise-constant-in-time
source is a legal member of the same problem family.  Every mechanism
below rides machinery the serving tier already has; no kernel is the
session's own:

* **Chunked stepping**: a session advances ``chunk_steps`` Euler steps
  at a time, each chunk one ordinary production
  :class:`~nonlocalheatequation_torch.serve.ensemble.EnsembleCase`
  (``nt=chunk_steps``, ``u0=`` the current state) submitted through the
  existing backend (a
  :class:`~nonlocalheatequation_torch.serve.server.ServePipeline` or a
  :class:`~nonlocalheatequation_torch.serve.router.ReplicaRouter`), so the
  kernel builds, the program store, supervision and fleet routing all
  work unchanged.  Between chunks the state lives on the host in f64; each
  chunk stages it into the engine's dtype.  The session's trajectory is
  DEFINED over its chunk grid: state(step) at every chunk boundary is a
  deterministic function of (spec, retarget log), which makes resume
  bit-identity a testable contract.
* **Session-sticky routing**: a session id is a long-lived sticky bucket
  key: chunks ride the router's ``sticky_key=("session", sid)``, so EVERY
  chunk (the final partial one included, whose ``nt`` differs and would
  otherwise hash to a different bucket owner) lands on the session's
  replica, keeping its programs warm.  A fork is a NEW key, placed
  anywhere, finding the parent's program recipes in the shared program
  store (same program key: same shape, chunk and physics).
* **Streaming**: every chunk boundary emits a coarse PREVIEW frame
  (``u[::stride]`` as f32) and completion emits the FINAL full-f64 frame.
  Frames are keyed by absolute step; :meth:`SessionManager.stream` (and
  the SSE endpoint ``GET /v1/sessions/<id>/stream`` in serve/http.py)
  deliver them in step order from any cursor, so a reconnecting or
  resumed reader loses nothing and duplicates nothing.
* **Retarget** (``POST .../retarget``): queued control verbs change the
  conductivity ``k`` and/or the additive source field ``b(x)`` AT THE
  NEXT CHUNK BOUNDARY (first-order operator splitting: a chunk of ``n``
  steps integrates the source as ``u += n*dt*b`` on the host, in f64, at
  its end).  The boundary step is recorded in the session's audit log,
  the EventLog and the trace.
* **Fork** (``POST .../fork``): a new session from any retained
  checkpoint boundary of the parent (or its live boundary state), with
  the parent lineage in its audit log.
* **Resume**: every ``checkpoint_every`` chunks the boundary state is
  saved crash-safe (utils/checkpoint.py ``save_session_checkpoint``:
  atomic replace + CRC, keyed by session id + step, the JAX package's
  file format).  Replica death inside a chunk is already invisible (the
  router re-routes orphans and re-serves bit-identically);
  :meth:`SessionManager.resume` covers the tier above: a dead front door
  or manager restarts, reloads the newest uncorrupted boundary, and
  re-emits the stream from there, bit-identical to an uninterrupted run.
* **Budgets**: per-session step budgets (``budget_steps`` per
  ``budget_window_s``) plus the fleet-wide session gate of the
  :class:`~nonlocalheatequation_torch.serve.http.AdmissionController`
  (``session_steps_per_s``) make a greedy streaming session DEFER at
  chunk granularity instead of starving the batch tier; session chunks
  also submit at priority -1 so batch work wins ties inside workers.
* **Observability**: every lifecycle event (open/chunk/retarget/fork/
  resume/close) lands in the EventLog, the span tracer (``session.chunk``
  spans, ``session.*`` instants), and the backend registry's
  ``/session/*`` counters and gauges, so one fleet scrape shows the
  session tier next to the batch tier.

Failures on the card follow the serving tier's rule: a chunk whose
backend request completes exceptionally fails its session (state
``"failed"``, the error kept); a card failure that an in-process pipeline
re-raises fails the session too and propagates out of ``pump`` (in a
fleet it ends the worker, and the router re-routes the chunk); no chunk
is ever served from the CPU by this module.

Threading: the manager is pumped: :meth:`pump` advances every session one
event (submit or retire) and never blocks; ``start_driver`` runs a daemon
pump loop for the HTTP tier; tests drive pump()/drive() with an injected
clock.  Shared state is lock-guarded (``guarded_by`` notes); the lock
order is manager, then session.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.export import EventLog
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase
from nonlocalheatequation_torch.serve.resilience import ServeError
from nonlocalheatequation_torch.serve.router import RouterOverloaded
from nonlocalheatequation_torch.utils.checkpoint import (
    list_session_checkpoints,
    load_session_checkpoint,
    save_session_checkpoint,
)

#: Env knobs for the session tier's defaults (scrubbed by
#: tests/conftest.py like every serve-tier knob family):
#: per-session step budget per window (0 = unlimited), checkpoint
#: cadence in CHUNKS (0 = off), preview downsample stride.
SESSION_BUDGET_ENV = "NLHEAT_SESSION_BUDGET"
SESSION_CKPT_ENV = "NLHEAT_SESSION_CKPT_EVERY"
SESSION_PREVIEW_ENV = "NLHEAT_SESSION_PREVIEW"

#: Frames retained per session (the stream window).  A session outliving
#: its window keeps streaming — old frames age out of the REPLAY buffer
#: only; ``frames_total`` stays lifetime-exact.  Live readers are never
#: behind by more than their poll cadence, and a resumed reader replays
#: from the last checkpoint, which the cadence keeps inside the window.
FRAMES_CAP = 4096

#: Ended (done/closed/failed) sessions retained for result/status polls
#: (the session twin of serve/http.py RESULTS_CAP): a long-running front
#: door serving many short sessions must not grow host memory with its
#: session count — each retained session holds its full f64 state plus
#: its frame buffer.  Older ended sessions age out FIFO; their on-disk
#: checkpoints remain, so an aged-out session is still resumable.
RETAIN_ENDED = 256

#: Retained checkpoint boundaries per session (0 = keep all).  Forks can
#: branch from any RETAINED boundary; resume wants only the newest.
CKPT_KEEP = 8

#: Frame-kind order at one step: the preview streams before the final.
#: Stream cursors are (step, rank) pairs so a FINAL frame emitted at a
#: step whose preview was already consumed (close_session mid-stream)
#: is still delivered — a bare step cursor would skip it.
KIND_RANK = {"preview": 0, "final": 1}


@dataclass
class SessionSpec:
    """What a session simulates and how it streams.

    The physics fields mirror :class:`EnsembleCase` (production form:
    ``test=False``, an explicit ``u0`` — the manufactured-source test
    path bakes absolute time into its program and cannot be chunked).
    ``nt`` is the TOTAL step count (None = open-ended, runs until
    closed); ``chunk_steps`` the stream granularity — one chunk = one
    dispatched program = one preview frame.  ``budget_steps`` caps the
    session's steps per ``budget_window_s`` (0 = unlimited, the
    env default ``NLHEAT_SESSION_BUDGET``); ``checkpoint_every`` is the
    crash-safe save cadence in chunks (0 = off, env
    ``NLHEAT_SESSION_CKPT_EVERY``); ``preview_stride`` the coarse-frame
    downsample (env ``NLHEAT_SESSION_PREVIEW``, default 4)."""

    shape: tuple
    eps: int
    k: float
    dt: float
    dh: float
    u0: np.ndarray
    nt: int | None = None
    chunk_steps: int = 16
    preview_stride: int | None = None
    budget_steps: int | None = None
    budget_window_s: float = 1.0
    checkpoint_every: int | None = None
    #: mesh-keyed session (serve/meshes.py): the content hash
    #: of a registered point cloud.  ``shape`` is then the node count
    #: ``(n,)`` and ``eps``/``dh`` ride as 0 — the mesh carries its own
    #: geometry (the EnsembleCase mesh semantics, serve/ensemble.py).
    mesh: str | None = None

    def validate(self) -> "SessionSpec":
        # every coercion is ASSIGNED, not just range-checked: a JSON
        # body's 2.5/"10" must become a real int/float here or it
        # detonates later inside the pump, past the client's 400
        self.shape = tuple(int(s) for s in self.shape)
        if not 1 <= len(self.shape) <= 3 or any(s < 1 for s in self.shape):
            raise ValueError(f"bad session shape {self.shape}")
        self.eps = int(self.eps)
        if self.mesh is not None:
            self.mesh = str(self.mesh)
        elif self.eps < 1:
            # a mesh-keyed session carries eps in the registered cloud
            # (eps rides as 0); grid sessions need a real horizon
            raise ValueError(f"session eps must be >= 1, got {self.eps}")
        self.k = float(self.k)
        self.dt = float(self.dt)
        self.dh = float(self.dh)
        if self.nt is not None:
            self.nt = int(self.nt)
            if self.nt < 1:
                raise ValueError(
                    f"session nt must be >= 1 (or None = open-ended), "
                    f"got {self.nt}")
        self.chunk_steps = int(self.chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError(
                f"chunk_steps must be >= 1, got {self.chunk_steps}")
        if self.u0 is None:
            raise ValueError(
                "a session needs an initial state u0 (sessions are "
                "production solves; the manufactured-source test path "
                "bakes absolute time into its program and cannot be "
                "chunked)")
        u0 = np.asarray(self.u0, np.float64)
        if u0.size != int(np.prod(self.shape)):
            raise ValueError(
                f"u0 has {u0.size} values, shape {self.shape} needs "
                f"{int(np.prod(self.shape))}")
        self.u0 = u0.reshape(self.shape)
        self.preview_stride = int(
            self.preview_stride if self.preview_stride is not None
            else os.environ.get(SESSION_PREVIEW_ENV) or 4)
        if self.preview_stride < 1:
            raise ValueError(
                f"preview_stride must be >= 1, got {self.preview_stride}")
        self.budget_steps = int(
            self.budget_steps if self.budget_steps is not None
            else os.environ.get(SESSION_BUDGET_ENV) or 0)
        if self.budget_steps < 0:
            raise ValueError(
                f"budget_steps must be >= 0 (0 = unlimited), got "
                f"{self.budget_steps}")
        self.budget_window_s = float(self.budget_window_s)
        if self.budget_window_s <= 0:
            raise ValueError(
                f"budget_window_s must be > 0, got {self.budget_window_s}")
        self.checkpoint_every = int(
            self.checkpoint_every if self.checkpoint_every is not None
            else os.environ.get(SESSION_CKPT_ENV) or 0)
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0 (0 = off), got "
                f"{self.checkpoint_every}")
        return self

    def params(self, k: float, source) -> dict:
        """The checkpoint parameter block: everything a resume needs to
        continue the SAME trajectory (current retargeted physics
        included — the saved k/source, not the opening ones)."""
        return {
            "shape": list(self.shape), "eps": int(self.eps),
            "k": float(k), "dt": float(self.dt), "dh": float(self.dh),
            "mesh": self.mesh,
            "nt": self.nt if self.nt is None else int(self.nt),
            "chunk_steps": int(self.chunk_steps),
            "preview_stride": int(self.preview_stride),
            "budget_steps": int(self.budget_steps),
            "budget_window_s": float(self.budget_window_s),
            "checkpoint_every": int(self.checkpoint_every),
            "source": (None if source is None
                       else np.asarray(source).ravel().tolist()),
        }


@dataclass
class Frame:
    """One stream emission: the field at a chunk boundary.  ``step`` is
    the ABSOLUTE step index (the dedup key a reconnecting reader
    cursors on); ``kind`` is "preview" (f32, ``::stride`` downsample)
    or "final" (full f64, emitted once at completion)."""

    step: int
    kind: str
    t: float
    shape: tuple
    values: np.ndarray

    def wire(self) -> dict:
        return {"step": int(self.step), "kind": self.kind,
                "t": float(self.t), "shape": list(self.values.shape),
                "dtype": str(self.values.dtype),
                "values": self.values.ravel().tolist()}


class Session:
    """One live simulation: state, stream buffer, audit trail.

    Mutated by the manager's pump (driver thread) and read by stream
    readers (HTTP handler threads) — every mutable field below is
    guarded by the session's own lock; :class:`SessionManager` methods
    hold it via ``with s._lock``.  ``state`` moves
    ``running -> done | closed | failed`` (done = reached ``nt``;
    closed = explicit close; failed = a chunk completed exceptionally —
    the typed ServeError is kept on ``error``)."""

    def __init__(self, sid: str, spec: SessionSpec, *, t0: int = 0,
                 u=None, clock=time.monotonic, parent: tuple | None = None,
                 resumed_from: int | None = None):
        self.sid = sid
        self.spec = spec
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self.state = "running"  # guarded_by: self._lock
        self.error = None  # guarded_by: self._lock
        self.step = int(t0)  # guarded_by: self._lock
        self.u = np.asarray(u if u is not None else spec.u0,
                            np.float64)  # guarded_by: self._lock
        self.k = float(spec.k)  # guarded_by: self._lock
        self.source = None  # guarded_by: self._lock
        self._frames: dict = {}  # (step, kind) -> Frame; guarded_by: self._lock
        self._order: list = []  # guarded_by: self._lock
        self.frames_total = 0  # guarded_by: self._lock
        self.chunks_done = 0  # guarded_by: self._lock
        self.deferrals = 0  # guarded_by: self._lock
        self.retarget_queue: list = []  # guarded_by: self._lock
        self.audit: list = []  # applied retargets/forks/resumes; guarded_by: self._lock
        self.inflight = None  # submitted chunk handle; guarded_by: self._lock
        self.inflight_steps = 0  # guarded_by: self._lock
        self.inflight_t0 = 0.0  # guarded_by: self._lock
        #: pump claim: at most ONE thread works this session's submit/
        #: retire at a time (stream() pumps from reader threads when no
        #: driver runs — without the claim two readers could both see
        #: inflight None and double-submit a chunk)
        self._pump_busy = False  # guarded_by: self._lock
        self.window_t0 = clock()  # guarded_by: self._lock
        self.steps_in_window = 0  # guarded_by: self._lock
        self.last_checkpoint: int | None = resumed_from  # guarded_by: self._lock
        self.parent = parent  # (parent sid, fork step) or None
        self.resumed_from = resumed_from

    # the router's long-lived placement identity (module docstring)
    def sticky_key(self) -> tuple:
        return ("session", self.sid)

    def _emit(self, frame: Frame) -> bool:  # locked: self._lock
        """Buffer one frame (dedup by (step, kind): a resume re-emitting
        an already-delivered boundary replaces it with the bit-identical
        recomputation instead of duplicating).  Returns True when the
        frame was NEW."""
        key = (frame.step, frame.kind)
        fresh = key not in self._frames
        if fresh:
            self._order.append(key)
            self.frames_total += 1
            while len(self._order) > FRAMES_CAP:
                self._frames.pop(self._order.pop(0), None)
        self._frames[key] = frame
        self._wake.notify_all()
        return fresh

    def frames_after(self, cursor: int, kind_rank: int = 0) -> list:
        """Buffered frames strictly past the ``(cursor, kind_rank)``
        stream position, in (step, preview-before-final) order — the
        stream reader's pull.  ``kind_rank`` (KIND_RANK) names the
        last-consumed frame AT the cursor step: the default 0 means
        only the preview there was seen, so a final frame at exactly
        ``cursor`` is still due (close_session emits one at the step
        whose preview already streamed)."""
        with self._lock:
            keys = sorted(self._frames,
                          key=lambda sk: (sk[0], KIND_RANK[sk[1]]))
            return [self._frames[sk] for sk in keys
                    if (sk[0], KIND_RANK[sk[1]]) > (cursor, kind_rank)]

    def status(self) -> dict:
        with self._lock:
            return {
                "session": self.sid, "state": self.state,
                "step": self.step,
                "nt": self.spec.nt,
                "t": self.step * self.spec.dt,
                "k": self.k,
                "source": self.source is not None,
                "chunk_steps": self.spec.chunk_steps,
                "chunks": self.chunks_done,
                "frames_total": self.frames_total,
                "deferrals": self.deferrals,
                "retargets_queued": len(self.retarget_queue),
                "audit": [dict(a) for a in self.audit],
                "last_checkpoint": self.last_checkpoint,
                "parent": self.parent,
                "resumed_from": self.resumed_from,
                "error": str(self.error) if self.error else None,
            }

    def result(self):
        """The final full-f64 field (None until done/closed)."""
        with self._lock:
            fr = self._frames.get((self.step, "final"))
            return None if fr is None else np.array(fr.values)


class SessionManager:
    """Owns every live session over one serving backend.

    ``backend`` is a ReplicaRouter (fleet form: chunks ride
    ``sticky_key``, deaths re-route invisibly) or a ServePipeline
    (in-process form: chunks fence per retire — the deterministic
    test/bench harness).  ``admission`` is the shared
    :class:`~nonlocalheatequation_torch.serve.http.AdmissionController`
    whose session gate chunks must clear (None = no fleet-wide gate;
    per-session budgets still apply).  ``checkpoint_dir`` enables
    crash-safe resume + checkpoint forks (None = off: forks branch from
    the live boundary state only and resume refuses).  ``clock`` is
    injectable for deterministic budget/starvation tests."""

    def __init__(self, backend, *, admission=None,
                 checkpoint_dir: str | None = None,
                 chunk_steps: int = 16, clock=time.monotonic,
                 registry: MetricsRegistry | None = None,
                 ckpt_keep: int = CKPT_KEEP,
                 retain_ended: int = RETAIN_ENDED):
        self.backend = backend
        self.admission = admission
        self.checkpoint_dir = checkpoint_dir
        self.default_chunk_steps = int(chunk_steps)
        self.ckpt_keep = int(ckpt_keep)
        self.retain_ended = int(retain_ended)
        self._clock = clock
        self.registry = (registry if registry is not None
                         else getattr(backend, "registry", None))
        if self.registry is None:
            self.registry = MetricsRegistry()
        r = self.registry
        self._m_opened = r.counter("/session/opened")
        self._m_closed = r.counter("/session/closed")
        self._m_completed = r.counter("/session/completed")
        self._m_failed = r.counter("/session/failed")
        self._m_active = r.gauge("/session/active")
        self._m_chunks = r.counter("/session/chunks")
        self._m_steps = r.counter("/session/steps")
        self._m_frames = r.counter("/session/frames")
        self._m_retargets = r.counter("/session/retargets")
        self._m_forks = r.counter("/session/forks")
        self._m_resumes = r.counter("/session/resumes")
        self._m_checkpoints = r.counter("/session/checkpoints")
        self._m_deferrals = r.counter("/session/deferrals")
        self._h_chunk_ms = r.histogram("/session/chunk-ms")
        self._events = EventLog.from_env()
        self._lock = threading.RLock()
        self._sessions: dict = {}  # guarded_by: self._lock
        #: ended sids in end order (FIFO aging to retain_ended);
        #: insertion-ordered like IngressServer._done
        self._ended: dict = {}  # guarded_by: self._lock
        self._next_sid = 0  # guarded_by: self._lock
        self._closed = False  # guarded_by: self._lock
        self._driver: threading.Thread | None = None
        self._stop_driver = threading.Event()

    # -- observability (never raises; one attribute read when off) ----------
    def _event(self, kind: str, **fields) -> None:
        if self._events is not None:
            self._events.emit(event=kind, **fields)

    # -- lifecycle ----------------------------------------------------------
    def open(self, spec: SessionSpec | None = None, *, sid: str | None = None,
             _t0: int = 0, _u=None, _parent=None, _resumed=None,
             **spec_kwargs) -> Session:
        """Open a session (pass a built :class:`SessionSpec` or its
        fields as kwargs) and emit its step-``_t0`` preview frame — the
        stream's first emission is the initial state, so a reader sees
        the field before the first chunk retires."""
        if spec is None:
            spec = SessionSpec(
                chunk_steps=spec_kwargs.pop("chunk_steps",
                                            self.default_chunk_steps),
                **spec_kwargs)
        elif spec_kwargs:
            raise ValueError(
                f"pass spec fields {sorted(spec_kwargs)} OR a built "
                "SessionSpec, not both")
        spec.validate()
        with self._lock:
            if self._closed:
                raise RuntimeError("session manager is closed")
            if sid is None:
                sid = f"s{self._next_sid}"
                self._next_sid += 1
            if sid in self._sessions:
                raise ValueError(f"session id {sid!r} already live")
            s = Session(sid, spec, t0=_t0, u=_u, clock=self._clock,
                        parent=_parent, resumed_from=_resumed)
            self._sessions[sid] = s
        self._m_opened.inc()
        self._m_active.set(self._active_count())
        with s._lock:
            self._emit_preview(s)
        obs_trace.instant("session.open", cat="session", session=sid,
                          step=_t0)
        self._event("session-open", session=sid, step=_t0,
                    shape=list(spec.shape), chunk_steps=spec.chunk_steps,
                    parent=list(_parent) if _parent else None,
                    resumed_from=_resumed)
        return s

    def _active_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values()
                       if s.state == "running")

    def _note_ended(self, sid: str) -> None:
        """Bounded retention of ended sessions (RETAIN_ENDED): the
        newest stay pollable (status/result/stream replay); older ones
        age out FIFO — their checkpoints remain on disk, so resume
        still works.  Called AFTER the session lock is released (the
        mgr -> session lock order)."""
        with self._lock:
            self._ended.setdefault(sid, None)
            while len(self._ended) > self.retain_ended:
                old = next(iter(self._ended))
                del self._ended[old]
                self._sessions.pop(old, None)

    def get(self, sid: str) -> Session:
        with self._lock:
            s = self._sessions.get(sid)
        if s is None:
            raise KeyError(f"no live session {sid!r}")
        return s

    def sessions(self) -> list:
        with self._lock:
            return list(self._sessions.values())

    def retarget(self, sid: str, *, k: float | None = None,
                 source=None, clear_source: bool = False) -> dict:
        """Queue a control verb: new conductivity ``k`` and/or additive
        source field ``b(x)`` (``clear_source`` drops an active one).
        Takes effect at the session's NEXT chunk boundary; the boundary
        step is recorded in the audit log when applied.  Returns the
        queued ticket (``requested_at_step`` = the current step)."""
        s = self.get(sid)
        if k is None and source is None and not clear_source:
            raise ValueError(
                "retarget needs k=, source=, or clear_source=True")
        if source is not None:
            source = np.asarray(source, np.float64)
            if source.size != int(np.prod(s.spec.shape)):
                raise ValueError(
                    f"source has {source.size} values, shape "
                    f"{s.spec.shape} needs {int(np.prod(s.spec.shape))}")
            source = source.reshape(s.spec.shape)
        with s._lock:
            if s.state != "running":
                raise ValueError(
                    f"session {sid!r} is {s.state}; retarget needs a "
                    "running session")
            ticket = {"verb": "retarget",
                      "requested_at_step": s.step,
                      "k": None if k is None else float(k),
                      "source": ("clear" if clear_source else
                                 "set" if source is not None else None)}
            s.retarget_queue.append(
                {"k": k, "source": source, "clear": clear_source,
                 "requested_at_step": s.step})
        self._m_retargets.inc()
        obs_trace.instant("session.retarget", cat="session", session=sid,
                          requested_at_step=ticket["requested_at_step"])
        self._event("session-retarget", session=sid,
                    requested_at_step=ticket["requested_at_step"],
                    k=ticket["k"], source=ticket["source"])
        return ticket

    def fork(self, sid: str, *, step: int | None = None) -> Session:
        """Branch a new session from ``sid``'s checkpoint at ``step``
        (None = the live boundary state when no checkpoint dir is
        configured, else the newest retained checkpoint).  The child is
        a NEW session id — a new sticky key, placed anywhere, finding
        the parent's program recipes in the shared program store —
        carrying the parent lineage in its audit log."""
        parent = self.get(sid)
        with parent._lock:
            # the live-state fork branches at the last retired BOUNDARY
            # (u/step) — an in-flight chunk's interior is nobody's state
            spec = parent.spec
            live_u = np.array(parent.u)
            live_step = parent.step
            k_now, src_now = parent.k, (None if parent.source is None
                                        else np.array(parent.source))
        if step is not None and self.checkpoint_dir is None:
            raise ValueError(
                "fork from a checkpoint step needs a checkpoint_dir")
        params = None
        if self.checkpoint_dir is not None:
            try:
                u, t0, params = load_session_checkpoint(
                    self.checkpoint_dir, sid, step)
            except FileNotFoundError:
                if step is not None:
                    raise
                params = None  # nothing retained yet: live-state fork
        if params is not None:
            k = float(params.get("k", spec.k))
            source = params.get("source")
            source = (None if source is None
                      else np.asarray(source,
                                      np.float64).reshape(spec.shape))
        else:
            u, t0, k, source = live_u, live_step, k_now, src_now
        child_spec = SessionSpec(
            shape=spec.shape, eps=spec.eps, k=k, dt=spec.dt, dh=spec.dh,
            mesh=spec.mesh,
            u0=u, nt=spec.nt, chunk_steps=spec.chunk_steps,
            preview_stride=spec.preview_stride,
            budget_steps=spec.budget_steps,
            budget_window_s=spec.budget_window_s,
            checkpoint_every=spec.checkpoint_every)
        child = self.open(child_spec, _t0=t0, _u=u, _parent=(sid, t0))
        with child._lock:
            child.source = source
            child.audit.append({"verb": "fork", "parent": sid,
                                "from_step": t0})
        self._m_forks.inc()
        obs_trace.instant("session.fork", cat="session", session=sid,
                          child=child.sid, from_step=t0)
        self._event("session-fork", session=sid, child=child.sid,
                    from_step=t0)
        return child

    def resume(self, sid: str) -> Session:
        """Restore ``sid`` from its newest uncorrupted checkpoint (the
        front-door/manager-death recovery; replica death inside a chunk
        never needs this — the router re-routes).  The resumed session
        keeps its id (and therefore its sticky key and stream identity)
        and re-emits frames from the checkpoint boundary onward,
        bit-identical to an uninterrupted run."""
        if self.checkpoint_dir is None:
            raise ValueError("resume needs a checkpoint_dir")
        with self._lock:
            if sid in self._sessions:
                raise ValueError(
                    f"session {sid!r} is already live; resume restores "
                    "a dead one")
        u, t0, params = load_session_checkpoint(self.checkpoint_dir, sid)
        spec = SessionSpec(
            shape=tuple(params["shape"]), eps=params["eps"],
            k=params["k"], dt=params["dt"], dh=params["dh"], u0=u,
            mesh=params.get("mesh"),
            nt=params.get("nt"), chunk_steps=params["chunk_steps"],
            preview_stride=params.get("preview_stride"),
            budget_steps=params.get("budget_steps"),
            budget_window_s=params.get("budget_window_s", 1.0),
            checkpoint_every=params.get("checkpoint_every"))
        s = self.open(spec, sid=sid, _t0=t0, _u=u, _resumed=t0)
        source = params.get("source")
        with s._lock:
            s.source = (None if source is None
                        else np.asarray(source,
                                        np.float64).reshape(spec.shape))
            s.audit.append({"verb": "resume", "from_step": t0})
        self._m_resumes.inc()
        obs_trace.instant("session.resume", cat="session", session=sid,
                          from_step=t0)
        self._event("session-resume", session=sid, from_step=t0)
        return s

    def close_session(self, sid: str) -> dict:
        """End a session now: its current boundary state becomes the
        final full-f64 frame and the stream completes."""
        s = self.get(sid)
        with s._lock:
            flipped = s.state == "running"
            if flipped:
                s.state = "closed"
                self._emit_final(s)
                s._wake.notify_all()
        if flipped:
            # idempotent: a double close (client retry, done session)
            # must not over-count /session/closed or re-emit events —
            # opened == completed + closed + failed must reconcile
            self._m_closed.inc()
            self._m_active.set(self._active_count())
            self._note_ended(sid)
            obs_trace.instant("session.close", cat="session", session=sid,
                              step=s.step)
            self._event("session-close", session=sid, step=s.step)
        return s.status()

    # -- frames -------------------------------------------------------------
    def _preview_of(self, s: Session) -> np.ndarray:  # locked: s._lock
        sl = tuple(slice(None, None, s.spec.preview_stride)
                   for _ in s.spec.shape)
        return np.ascontiguousarray(s.u[sl].astype(np.float32))

    def _emit_preview(self, s: Session) -> None:  # locked: s._lock
        fresh = s._emit(Frame(step=s.step, kind="preview",
                              t=s.step * s.spec.dt, shape=s.spec.shape,
                              values=self._preview_of(s)))
        if fresh:
            self._m_frames.inc()

    def _emit_final(self, s: Session) -> None:  # locked: s._lock
        fresh = s._emit(Frame(step=s.step, kind="final",
                              t=s.step * s.spec.dt, shape=s.spec.shape,
                              values=np.array(s.u, np.float64)))
        if fresh:
            self._m_frames.inc()

    def stream(self, sid: str, *, from_step: int = -1,
               timeout_s: float = 30.0, poll_s: float = 0.05):
        """Yield :class:`Frame` objects with ``step > from_step`` in
        step order until the session leaves ``running`` and its buffer
        is drained (or nothing new arrives for ``timeout_s`` — a parked
        reader must not leak its thread).  Pumps the manager while it
        waits when no driver thread is running, so a bare
        manager+pipeline needs no extra machinery to stream."""
        s = self.get(sid)
        # (step, kind-rank) cursor: a final frame at exactly from_step
        # is (re-)delivered — the reconnecting reader may have seen only
        # the preview there before the session closed; re-delivery is
        # idempotent under the (step, kind) dedup key
        cursor = (int(from_step), KIND_RANK["preview"])
        deadline = self._clock() + timeout_s
        while True:
            # the frames and the state in one critical section: a session
            # that ends between two separate reads would otherwise end the
            # stream with its last frames unread (the retire emits them and
            # flips the state under this same lock)
            with s._lock:
                batch = s.frames_after(*cursor)
                running = s.state == "running"
            for fr in batch:
                pos = (fr.step, KIND_RANK[fr.kind])
                if pos > cursor:
                    cursor = pos
                yield fr
            if batch:
                deadline = self._clock() + timeout_s
                continue
            if not running:
                return
            if self._clock() >= deadline:
                return
            if self._driver is None:
                self.pump(block=True)
            else:
                with s._lock:
                    s._wake.wait(poll_s)

    # -- the pump (chunk submit/retire) --------------------------------------
    def pump(self, block: bool = False) -> int:
        """Advance every session one event: retire a completed chunk
        (emit frame, apply queued retargets, checkpoint) or submit the
        next one (budget + admission gates willing).  ``block=True``
        additionally waits for ONE in-flight chunk to finish (the
        deterministic drive for pipeline backends).  Returns the number
        of progress events."""
        moved = 0
        for s in self.sessions():
            moved += self._pump_session(s, block=block)
        return moved

    def drive(self, *, timeout_s: float = 300.0) -> None:
        """Pump until no session is running (the drain of the session
        tier: bounded sessions complete, open-ended ones must be closed
        first)."""
        deadline = self._clock() + timeout_s
        while self._active_count():
            if self.pump(block=True) == 0:
                time.sleep(0.001)  # every session deferred: let the
                # budget window roll instead of spinning hot
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"sessions still running after {timeout_s:.0f}s")

    def start_driver(self, poll_s: float = 0.005) -> None:
        """Run the pump on a daemon thread (the HTTP tier's drive)."""
        if self._driver is not None:
            return
        self._stop_driver.clear()

        def loop():
            while not self._stop_driver.wait(poll_s):
                try:
                    self.pump(block=False)
                except Exception as e:  # noqa: BLE001 — the driver must
                    # survive a transient backend refusal; sessions fail
                    # individually through their own error path
                    print(f"sessions: pump failed ({e!r})",
                          file=sys.stderr)

        self._driver = threading.Thread(target=loop, daemon=True,
                                        name="nlheat-session-driver")
        self._driver.start()

    def _handle_done(self, s: Session, h) -> bool:
        done = getattr(h, "done", None)
        if done is not None:
            return done.is_set()
        # pipeline handle: advance the scheduler, then check
        pump = getattr(self.backend, "pump", None)
        if pump is not None:
            with self._backend_call(s):
                pump()
        return h.result is not None or h.error is not None

    def _wait_handle(self, s: Session, h, timeout_s: float = 600.0) -> None:
        done = getattr(h, "done", None)
        if done is not None:
            done.wait(timeout_s)
            return
        try:
            with self._backend_call(s):
                h.wait()  # pipeline fence; ServeError lands on h.error
        except ServeError:
            pass  # the retire path fails the session with h.error

    @contextlib.contextmanager
    def _backend_call(self, s: Session):
        """A call into the backend that may raise past its classification:
        the port's pipeline with its engine on the card classifies only
        injected faults and re-raises any other failure (serve/server.py
        ``_raise_card_fault``).  Such a failure fails the session and
        propagates; the chunk is never served again, on the CPU or
        elsewhere.  The pipeline's typed ServeError is left to the caller."""
        try:
            yield
        except (ServeError, RouterOverloaded):
            raise
        except Exception as e:
            with s._lock:
                s.inflight = None
            self._fail(s, e)
            raise

    def _pump_session(self, s: Session, block: bool) -> int:
        # claim the session: stream() pumps from reader threads when no
        # driver runs, and two concurrent pumps observing inflight None
        # would double-submit a chunk (orphaning one handle and double-
        # counting the budget window)
        with s._lock:
            if s.state != "running" or s._pump_busy:
                return 0
            s._pump_busy = True
            h = s.inflight
        try:
            if h is not None:
                if block and not self._handle_done(s, h):
                    self._wait_handle(s, h)
                if not self._handle_done(s, h):
                    return 0
                self._retire_chunk(s, h)
                return 1
            return self._submit_chunk(s)
        finally:
            with s._lock:
                s._pump_busy = False

    def _submit_chunk(self, s: Session) -> int:
        now = self._clock()
        with s._lock:
            n = s.spec.chunk_steps
            if s.spec.nt is not None:
                n = min(n, int(s.spec.nt) - s.step)
            if n <= 0:
                # nothing left (an nt reached exactly at a boundary is
                # finished by the retire path; this covers nt == t0).
                # Only the state flip happens under the session lock:
                # _active_count takes the MANAGER lock, and metrics()
                # holds it while reading sessions — taking it here
                # would invert the mgr -> session lock order
                s.state = "done"
                self._emit_final(s)
                s._wake.notify_all()
            else:
                # per-session budget: a rolling window of budget_steps
                if s.spec.budget_steps:
                    if now - s.window_t0 >= s.spec.budget_window_s:
                        s.window_t0 = now
                        s.steps_in_window = 0
                    if s.steps_in_window + n > s.spec.budget_steps:
                        s.deferrals += 1
                        self._m_deferrals.inc()
                        return 0
                case = EnsembleCase(
                    shape=s.spec.shape, nt=n, eps=s.spec.eps, k=s.k,
                    dt=s.spec.dt, dh=s.spec.dh, test=False,
                    u0=np.array(s.u), mesh=s.spec.mesh)
                sticky = s.sticky_key()
        if n <= 0:
            self._m_completed.inc()
            self._m_active.set(self._active_count())
            self._note_ended(s.sid)
            return 1
        # the fleet-wide session gate (serve/http.py AdmissionController):
        # a saturated batch tier defers session chunks — deferral, never
        # an error (outside the session lock: the gate reads the backend)
        if self.admission is not None:
            retry = self.admission.admit_session(n)
            if retry is not None:
                with s._lock:
                    s.deferrals += 1
                self._m_deferrals.inc()
                return 0
        try:
            # session chunks yield ties to the batch tier (priority -1);
            # the sticky key is the session's placement identity (the
            # router pins it; the in-process pipeline accepts + ignores)
            with self._backend_call(s):
                h = self.backend.submit(case, priority=-1, sticky_key=sticky)
        except RouterOverloaded:
            # the router's hard cap: defer, exactly like the soft gate
            with s._lock:
                s.deferrals += 1
            self._m_deferrals.inc()
            return 0
        with s._lock:
            s.inflight = h
            s.inflight_steps = n
            s.inflight_t0 = now
            if s.spec.budget_steps:
                s.steps_in_window += n
        return 1

    def _retire_chunk(self, s: Session, h) -> None:
        t1 = self._clock()
        err = h.error
        if err is None and h.result is None:
            err = RuntimeError("chunk handle completed with no result")
        if err is not None:
            with s._lock:
                s.inflight = None
            self._fail(s, err)
            return
        applied = []
        with s._lock:
            n = s.inflight_steps
            t0 = getattr(s, "inflight_t0", t1)
            s.inflight = None
            u = np.asarray(h.result, np.float64)
            # first-order source splitting at the chunk boundary (module
            # docstring): the active piecewise-constant b(x) integrates
            # as one n*dt impulse per chunk
            if s.source is not None:
                u = u + (n * s.spec.dt) * s.source
            s.u = u
            s.step += n
            s.chunks_done += 1
            # chunk-boundary control plane: queued retargets apply HERE,
            # with the boundary step recorded as auditable evidence
            for rt in s.retarget_queue:
                entry = {"verb": "retarget", "applied_at_step": s.step,
                         "requested_at_step": rt["requested_at_step"]}
                if rt["k"] is not None:
                    s.k = float(rt["k"])
                    entry["k"] = s.k
                if rt["clear"]:
                    s.source = None
                    entry["source"] = "clear"
                elif rt["source"] is not None:
                    s.source = rt["source"]
                    entry["source"] = "set"
                s.audit.append(entry)
                applied.append(entry)
            s.retarget_queue = []
            self._emit_preview(s)
            finished = s.spec.nt is not None and s.step >= int(s.spec.nt)
            ckpt_due = (self.checkpoint_dir is not None
                        and s.spec.checkpoint_every
                        and s.chunks_done % s.spec.checkpoint_every == 0)
            if finished:
                s.state = "done"
                self._emit_final(s)
                s._wake.notify_all()
            if ckpt_due or (finished and self.checkpoint_dir is not None
                            and s.spec.checkpoint_every):
                save_session_checkpoint(
                    self.checkpoint_dir, s.sid, s.step, s.u,
                    s.spec.params(s.k, s.source), keep=self.ckpt_keep)
                s.last_checkpoint = s.step
                self._m_checkpoints.inc()
            step_now = s.step
        self._m_chunks.inc()
        self._m_steps.inc(n)
        self._h_chunk_ms.observe((t1 - t0) * 1e3)
        if obs_trace.get_tracer() is not None:
            obs_trace.get_tracer().complete(
                "session.chunk", t0, t1, cat="session", session=s.sid,
                step=step_now, steps=n)
        self._event("session-chunk", session=s.sid, step=step_now,
                    steps=n, retargets_applied=len(applied))
        for entry in applied:
            obs_trace.instant("session.retarget-applied", cat="session",
                              session=s.sid, step=entry["applied_at_step"])
            self._event("session-retarget-applied", session=s.sid,
                        **entry)
        if finished:
            self._m_completed.inc()
            self._m_active.set(self._active_count())
            self._note_ended(s.sid)
            obs_trace.instant("session.done", cat="session",
                              session=s.sid, step=step_now)
            self._event("session-done", session=s.sid, step=step_now)

    def _fail(self, s: Session, err: BaseException) -> None:
        """End a running session as "failed" with ``err`` kept on it."""
        with s._lock:
            if s.state != "running":
                return
            s.state = "failed"
            s.error = err
            s._wake.notify_all()
        self._m_failed.inc()
        self._m_active.set(self._active_count())
        self._note_ended(s.sid)
        obs_trace.instant("session.failed", cat="session",
                          session=s.sid, step=s.step,
                          error=type(err).__name__)
        self._event("session-failed", session=s.sid, step=s.step,
                    detail=str(err))

    # -- checkpoint surface ---------------------------------------------------
    def checkpoints(self, sid: str) -> list:
        if self.checkpoint_dir is None:
            return []
        return list_session_checkpoints(self.checkpoint_dir, sid)

    # -- shutdown -------------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            per = {sid: s.status() for sid, s in self._sessions.items()}
        r = self.registry

        def val(name):
            m = r.get(name)
            return m.value if m is not None else 0

        return {
            "active": self._active_count(),
            "opened": val("/session/opened"),
            "completed": val("/session/completed"),
            "closed": val("/session/closed"),
            "failed": val("/session/failed"),
            "chunks": val("/session/chunks"),
            "steps": val("/session/steps"),
            "frames": val("/session/frames"),
            "retargets": val("/session/retargets"),
            "forks": val("/session/forks"),
            "resumes": val("/session/resumes"),
            "checkpoints": val("/session/checkpoints"),
            "deferrals": val("/session/deferrals"),
            "chunk_ms": self._h_chunk_ms.percentiles(),
            "sessions": per,
        }

    def close(self) -> None:
        """Stop the driver and end every running session (their current
        boundary state becomes the final frame — a closing front door
        must never leave a stream reader parked).  The backend is the
        caller's: never closed here."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop_driver.set()
        if self._driver is not None:
            self._driver.join(timeout=5.0)
            self._driver = None
        for s in self.sessions():
            with s._lock:
                if s.state == "running":
                    s.state = "closed"
                    self._emit_final(s)
                    s._wake.notify_all()
                    self._m_closed.inc()
        self._m_active.set(0)
        if self._events is not None:
            self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def session_stream_bench(engine_kwargs: dict, *, sessions: int,
                         grid: int, chunk_steps: int, chunks: int,
                         batch_cases: int, replicas: int = 2,
                         dt: float = 1e-7, eps: int = 8,
                         batch_rate_factor: float = 0.5,
                         queue_wait_bound_ms: float | None = None) -> dict:
    """The session-tier measurement (the port's counterpart of the JAX
    bench's ``BENCH_SESSION`` rung): ``sessions`` concurrent
    streaming sessions (each ``chunks`` chunks of ``chunk_steps`` steps)
    driven over a ``replicas``-worker fleet WHILE a paced batch load runs
    through the shared admission controller.  The session gate is set to
    HALF the fleet's measured step capacity, so the acceptance question
    is concrete: with budgets active, a saturating session tier must
    leave the batch tier's p99 inside the admission bound and shed
    nothing (``budget_held``), with the sessions' appetite visibly
    deferred (``deferrals``).  Frames/s is the stream throughput at the
    chunk cadence.  ``engine_kwargs`` carry the workers' engine (``device``,
    ``dtype``, ...), as for router_load_ab."""
    from nonlocalheatequation_torch.serve.http import (
        AdmissionController,
        offered_load_run,
    )
    from nonlocalheatequation_torch.serve.router import ReplicaRouter

    rng = np.random.default_rng(0)
    phys = dict(eps=eps, k=1.0, dt=dt, dh=1.0 / grid)
    batch = [EnsembleCase(shape=(grid, grid), nt=chunk_steps,
                          test=False,
                          u0=rng.normal(size=(grid, grid)), **phys)
             for _ in range(batch_cases)]
    out: dict = {"sessions": sessions, "chunks": chunks,
                 "chunk_steps": chunk_steps}
    with ReplicaRouter(replicas=replicas, **engine_kwargs) as router:
        router.serve_cases(batch)  # warm pass: builds and tunes
        t0 = time.perf_counter()
        router.serve_cases(batch)
        unloaded_wall = time.perf_counter() - t0
        hist = router.registry.get("/router/request-latency-ms")
        tail = list(hist.samples)[-len(batch):]
        unloaded_p99 = float(np.percentile(tail, 99))
        capacity_hz = len(batch) / unloaded_wall
        bound_ms = (queue_wait_bound_ms if queue_wait_bound_ms
                    else max(250.0, 5.0 * unloaded_p99))
        # the session gate: HALF the measured step capacity, burst
        # pinned to ONE chunk so the gate engages at any scale (the
        # smoke harness's 32^2 runs included, not only past the first
        # second of streaming)
        rate = 0.5 * capacity_hz * chunk_steps
        adm = AdmissionController(router, session_steps_per_s=rate,
                                  session_burst_steps=chunk_steps)
        with SessionManager(router, admission=adm,
                            chunk_steps=chunk_steps) as mgr:
            t0 = time.perf_counter()
            for i in range(sessions):
                mgr.open(shape=(grid, grid),
                         u0=rng.normal(size=(grid, grid)),
                         nt=chunks * chunk_steps,
                         chunk_steps=chunk_steps, budget_steps=0,
                         checkpoint_every=0, **phys)
            mgr.start_driver()
            sweep = offered_load_run(
                adm, batch + batch, batch_rate_factor * capacity_hz)
            sweep.pop("results", None)
            mgr.drive(timeout_s=600.0)
            wall = time.perf_counter() - t0
            m = mgr.metrics()
        p99_ms = sweep["latency_s"]["p99"] * 1e3
        out.update(
            wall_s=wall,
            unloaded_wall_s=unloaded_wall,
            capacity_hz=round(capacity_hz, 3),
            frames=m["frames"],
            frames_per_s=round(m["frames"] / wall, 3),
            steps_streamed=m["steps"],
            deferrals=m["deferrals"],
            session_rate_steps_s=round(rate, 1),
            batch={"offered": sweep["offered"],
                   "accepted": sweep["accepted"],
                   "shed": sweep["shed"],
                   "p99_ms": round(p99_ms, 3)},
            bound_ms=round(bound_ms, 3),
            unloaded_p99_ms=round(unloaded_p99, 3),
            # the acceptance: budgets held IF the batch tier shed
            # nothing, its p99 stayed inside the admission bound, and
            # the sessions' appetite was genuinely deferred
            budget_held=bool(sweep["shed"] == 0 and p99_ms <= bound_ms
                             and m["deferrals"] > 0),
        )
    return out


def session_resume_ab(engine_kwargs: dict, *, grid: int,
                      chunk_steps: int, chunks: int, ckpt_dir: str,
                      dt: float = 1e-7, eps: int = 8) -> dict:
    """The resume bit-identity measurement (the port's counterpart of the
    JAX bench's resume A/B): ONE session run uninterrupted vs the same
    spec killed after half its chunks (manager close — the front-door
    death; checkpoints stay on disk) and resumed by a fresh manager.
    The resumed stream's frames, deduped by (step, kind), must equal
    the uninterrupted run's bitwise, final f64 field included."""
    from nonlocalheatequation_torch.serve.server import ServePipeline

    rng = np.random.default_rng(1)
    phys = dict(eps=eps, k=1.0, dt=dt, dh=1.0 / grid)
    u0 = rng.normal(size=(grid, grid))
    nt = chunks * chunk_steps

    def frames_of(mgr, sid):
        return {(f.step, f.kind): np.array(f.values)
                for f in mgr.get(sid).frames_after(-1)}

    with ServePipeline(depth=1, window_ms=0.0, **engine_kwargs) as pipe:
        with SessionManager(pipe, chunk_steps=chunk_steps) as mgr:
            a = mgr.open(shape=(grid, grid), u0=u0, nt=nt,
                         checkpoint_every=0, **phys)
            mgr.drive(timeout_s=600.0)
            want_final = a.result()
            want_frames = frames_of(mgr, a.sid)
    kill_at = max(1, chunks // 2) * chunk_steps
    with ServePipeline(depth=1, window_ms=0.0, **engine_kwargs) as pipe:
        mgr = SessionManager(pipe, checkpoint_dir=ckpt_dir,
                             chunk_steps=chunk_steps)
        b = mgr.open(shape=(grid, grid), u0=u0, nt=nt,
                     checkpoint_every=1, **phys)
        sid = b.sid
        while b.step < kill_at:
            if b.state != "running":
                # a chunk completed exceptionally before the kill
                # point: fail the measurement loudly instead of
                # hot-spinning until the external budget kills us
                raise RuntimeError(
                    f"session_resume_ab: session {b.state!r} before "
                    f"the kill point ({b.status()['error']})")
            mgr.pump(block=True)
        pre = frames_of(mgr, sid)
        mgr.close()  # the injected front-door death
    with ServePipeline(depth=1, window_ms=0.0, **engine_kwargs) as pipe:
        with SessionManager(pipe, checkpoint_dir=ckpt_dir) as mgr2:
            br = mgr2.resume(sid)
            resumed_from = br.resumed_from
            mgr2.drive(timeout_s=600.0)
            got_final = br.result()
            got = dict(pre)
            got.update(frames_of(mgr2, sid))
    bit = bool(
        np.array_equal(got_final, want_final)
        and set(got) == set(want_frames)
        and all(np.array_equal(got[key], want_frames[key])
                for key in want_frames))
    return {"bit_identical": bit, "resumed_from": resumed_from,
            "kill_at": kill_at, "frames": len(want_frames)}
