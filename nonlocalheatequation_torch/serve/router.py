"""Replica-fleet router: N ServePipeline worker processes, one front door —
the port's copy of ``nonlocalheatequation_torch/serve/router.py``.

The reference's top tier is many HPX localities behind an idle-rate-driven
dynamic load balancer (src/2d_nonlocal_distributed.cpp:844-959); the
single-process :class:`~nonlocalheatequation_torch.serve.server.ServePipeline`
matches the scheduler half of that story but owns exactly one engine.  This
module is the fleet half: a router that owns N replica WORKER PROCESSES —
each a full ServePipeline over its own EnsembleEngine — and routes submitted
cases across them:

* **Sticky bucket routing** — a case's ensemble bucket key
  (``EnsembleCase.bucket_key()``, or the caller's ``sticky_key``) is pinned
  to one replica the first time it is seen, so every replica's bounded
  program cache (serve/ensemble.py) stays hot for the buckets it owns.  All
  replicas share one program store dir (``NLHEAT_PROGRAM_STORE``,
  serve/program_store.py), so a bucket moved to (or first touched by) any
  replica boots from the fleet's kernel libraries and tuned recipes: no
  nvcc run and no probe.
* **Elastic add/drain** — each worker reports the busy fraction of its
  serving loop (host wall) per stats window; the router feeds those into
  the busy-rate policy of the tile executor (parallel/elastic.py
  :class:`~nonlocalheatequation_torch.parallel.elastic.BusyRatePolicy` +
  :func:`~nonlocalheatequation_torch.parallel.elastic.fleet_scale_decision`)
  and adds a worker when the whole fleet is saturated / drains one when
  the whole fleet is idle.  Adding a replica rebalances bucket ownership
  toward it; draining reassigns the leaver's buckets and lets its
  in-flight cases finish.
* **Replica death is a first-class event** — a reader thread per worker
  notices EOF on the worker's frame channel; every case in flight on the
  dead worker is RE-ROUTED to a survivor (respawning one first when the
  fleet would drop below its floor) and re-served bitwise (results are
  deterministic functions of the case).  No case is lost, none is
  delivered twice.  The deterministic worker-kill plan kind ``die``
  (utils/faults.py) makes the path provable: the router draws from its
  plan at each case-forward event and SIGKILLs the worker a fired case
  was just routed to.  A real card failure inside a worker is never
  classified there: the worker's pipeline raises, the worker ends, and
  the router counts a death and re-routes — no worker serves a card's
  case from the CPU.

The card (the port's own rules):

* the router process never creates a CUDA context.  Workers start by
  exec (``python -m nonlocalheatequation_torch.serve.router``), never by
  forking a process that may hold one; frames carry NumPy arrays and
  plain values; :meth:`RouterRequest.wait` returns ``np.ndarray``;
* one nvcc build per fleet: when the workers' device is the card the
  router builds (or restores from the program store) every kernel
  library once, before the first spawn (``ops/_build.build`` runs nvcc,
  which needs no context), so N cold workers never start N compilers;
* the pipe worker takes fd 1 before it imports torch, so no library's
  print can reach the frame channel;
* each worker's engine takes ``device``/``dtype`` from the router's
  engine kwargs (``device=None``: the default card, as every entry point
  of the port; the worker raises when there is none).  Pipeline replicas
  share the default card and time-slice it; the gang replica takes
  ``gang_devices`` devices of its own process.

Transport: length-prefixed pickle frames over a :mod:`serve.transport`
worker transport — stdin/stdout pipes by default, or TCP sockets
(``transport="tcp"``: workers started with ``--worker-connect host:port``
dial in and speak the identical frames).  The trust model is the program
store's: the router and its workers are one principal — on one host over
pipes/loopback, or across hosts behind the shared token the socket
transport's hello verifies (serve/transport.py trust boundary).

Case classes: cases at or below ``shard_threshold`` grid points batch onto
the ServePipeline replicas; a 2D grid ABOVE it is dispatched to the **gang
replica** — a worker that owns an N-device mesh and solves the case as ONE
space-parallel distributed solve (``comm='fused'`` halo kernels where they
serve the configuration, the collective transport where ``require_fused``
refuses), streaming the result back bitwise the offline
:class:`~nonlocalheatequation_torch.parallel.distributed2d.Solver2DDistributed`
run (parallel/gang.py ``solve_case_sharded`` is the one adapter both sides
call).

Backpressure: the router's queues are BOUNDED — ``submit`` raises the
typed :class:`RouterOverloaded` (with a retry-after estimate from the
observed latency window) once ``max_outstanding`` cases per live replica
are in flight.  The HTTP ingestion tier (serve/http.py) sheds on this
(and on its own softer admission rule) with 429 + Retry-After.

Observability: the router's registry carries ``/router/*`` counters and
gauges (cases, routed, requeued, deaths, scale events, outstanding,
latency histogram), per-replica ``/replica{r}/busy-rate`` gauges, and —
after each stats pull — every worker's own registry snapshot absorbed
under ``/replica{r}`` prefixes (obs/metrics.absorb_snapshot), so ONE
scrape of the router registry exposes the whole fleet.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and "--worker-connect" not in sys.argv[1:]:
    # the pipe worker: its frame channel is the ORIGINAL fd 1, taken here,
    # before torch (or nvcc, or the CUDA runtime) can print to stdout and
    # tear the framing; fd 1 then points at stderr
    _FRAME_FD = os.dup(1)
    os.dup2(2, 1)
else:
    _FRAME_FD = None

import pickle  # noqa: E402 — after the fd 1 hand-over above
import queue  # noqa: E402
import select  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from nonlocalheatequation_torch.obs import flightrec  # noqa: E402
from nonlocalheatequation_torch.obs import slo as obs_slo  # noqa: E402
from nonlocalheatequation_torch.obs import trace as obs_trace  # noqa: E402
from nonlocalheatequation_torch.obs.export import REPLICA_ID_ENV  # noqa: E402
from nonlocalheatequation_torch.obs.metrics import (  # noqa: E402
    MetricsRegistry,
    absorb_snapshot,
)
from nonlocalheatequation_torch.obs.trace import (  # noqa: E402
    TraceContext,
    merge_chrome_traces,
    write_chrome_trace,
)
from nonlocalheatequation_torch.parallel.elastic import (  # noqa: E402
    BusyRatePolicy,
    FleetTelemetry,
    fleet_scale_decision,
)
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase  # noqa: E402
from nonlocalheatequation_torch.serve.picker import EngineChoice  # noqa: E402
from nonlocalheatequation_torch.serve.resilience import ServeError  # noqa: E402
from nonlocalheatequation_torch.serve.transport import (  # noqa: E402
    LEN as _LEN,
    MAX_FRAME_BYTES,
    WORKER_TOKEN_ENV,
    make_transport,
    write_frame as _write_frame,
    write_json_frame,
)
from nonlocalheatequation_torch.utils.faults import FaultPlan  # noqa: E402

#: Default per-replica in-flight bound (cases routed but not yet
#: delivered).  The router's queues must stay bounded no matter how fast
#: callers submit — admission control (serve/http.py) sheds SOFTLY ahead
#: of this hard refusal.
MAX_OUTSTANDING = 64

#: Re-routes a case may survive before completing exceptionally.  A case
#: whose replica keeps dying is indistinguishable from a case that KILLS
#: its replicas — unbounded re-routing would crash-loop the entire fleet
#: on one poison request (the router-level twin of the pipeline's
#: retry-then-quarantine budget).
MAX_REQUEUES = 3


class RouterOverloaded(RuntimeError):
    """The router's bounded queue is full.  ``retry_after_s`` is the
    suggested backoff (the ingress tier's Retry-After header)."""

    def __init__(self, outstanding: int, cap: int, retry_after_s: float):
        super().__init__(
            f"router overloaded: {outstanding} cases in flight "
            f"(cap {cap}); retry in {retry_after_s:.2f}s")
        self.outstanding = outstanding
        self.cap = cap
        self.retry_after_s = retry_after_s


class RouterRequest:
    """One routed case: the caller's handle (a cross-process future)."""

    def __init__(self, case: EnsembleCase, seq: int, submit_t: float):
        self.case = case
        self.seq = seq
        self.submit_t = submit_t
        self.deadline_ms = None
        self.priority = 0
        #: picked engine (serve/picker.py EngineChoice) riding the case
        #: frame to the worker; None = the fleet's default engine
        self.engine = None
        #: routing identity override (serve/sessions.py): a session's
        #: chunks all carry ("session", sid) so the final partial chunk
        #: (different nt -> different bucket key) still lands on the
        #: session's replica; None = the case's own bucket key
        self.sticky_key = None
        self.trace: TraceContext | None = None  # fleet trace identity
        self.trace_minted = False  # router-minted (no ingress root)
        self._flow_started = False  # first flow hop already emitted
        self.result: np.ndarray | None = None
        self.error: ServeError | None = None
        self.latency_s: float | None = None
        self.replica: int | None = None  # current owner
        self.requeues = 0  # times re-routed after a replica death
        self.done = threading.Event()

    def wait(self, timeout: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"case {self.seq} not served within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class _Replica:
    """Router-side worker handle: the process, its framed pipes, the
    reader/writer threads' state, and the bucket set it owns.

    Sends are ASYNCHRONOUS: ``send`` enqueues and a dedicated writer
    thread drains the queue into the worker's stdin pipe.  A worker
    mid-compute stops reading its pipe, and the 64 KB pipe buffer would
    otherwise block the ROUTER's submitting thread on the next frame —
    throttling intake to the fleet's service rate, which makes overload
    unobservable (the queue the admission gate bounds could never
    form).  The router-side queue is part of the case's in-flight
    accounting, so the bound still holds end to end."""

    def __init__(self, rid: int, handle, gang: bool = False):
        self.rid = rid
        self.handle = handle  # transport WorkerHandle (pipes or socket)
        self.gang = gang  # the sharded-case worker (N-device mesh)
        self.sendq: "queue.Queue" = queue.Queue()
        self.ready = threading.Event()
        self.alive = True
        self.closing = False  # router-initiated stop: EOF is not a death
        self.draining = False  # no NEW buckets/cases route here
        self.outstanding: dict[int, RouterRequest] = {}
        self.buckets: set = set()
        # token -> [event, box]: one waiter per pulled reply frame
        # (stats AND trace dumps share the token space/mechanism)
        self.stats_waiters: dict[int, list] = {}
        self.last_stats: dict | None = None
        #: the worker's (monotonic, wall) clock pair, exchanged on the
        #: hello frame — merge_chrome_traces aligns per-process
        #: monotonic-epoch span timestamps with it (obs/trace.py)
        self.clock_sync: dict | None = None

    def send(self, obj) -> bool:
        """Enqueue one frame for the writer thread (never blocks on the
        pipe).  False only when the worker is already known-dead."""
        if not self.alive:
            return False
        self.sendq.put(obj)
        return True

    def _writer(self) -> None:
        """Drain the send queue into the worker's stdin.  A broken pipe
        ends the thread quietly — the reader's EOF owns death handling.
        The ``__kill__`` sentinel (the fault plan's ``die``) is ORDERED
        with the frames before it: the case it spans is genuinely in
        flight on the worker when the SIGKILL lands."""
        while True:
            obj = self.sendq.get()
            if obj is None:
                return
            if isinstance(obj, dict) and obj.get("op") == "__kill__":
                self.handle.kill()
                continue
            try:
                self.handle.send_frame(obj)
            except (OSError, ValueError):
                return


class ReplicaRouter:
    """Own N replica worker processes; route cases sticky-by-bucket.

    ``replicas`` is the starting fleet size (also the floor unless
    ``min_replicas`` says otherwise); ``max_replicas`` caps elastic
    growth (default ``2 * replicas``).  ``program_store`` is the shared
    program store dir every worker resolves (None = inherit the ambient
    ``NLHEAT_PROGRAM_STORE``).  ``depth``/``window_ms``/``window_size``
    and ``serve_kwargs`` configure each worker's ServePipeline;
    remaining ``engine_kwargs`` its EnsembleEngine.  ``faults`` (or a
    spec string) is the ROUTER-level deterministic plan — the ``die``
    kind kills workers; the plan is scrubbed from worker environments so
    it can never double-inject inside their pipelines.  ``child_env``
    adds/overrides worker env vars.  ``engine_kwargs`` carry the
    engine's ``device`` (None: the CUDA card; ``"cpu"`` for the CPU) and
    ``dtype``; every worker's engine takes them, and when the device is
    the card the router builds the kernel libraries once before the
    first spawn (:meth:`_prebuild`)."""

    def __init__(self, replicas: int = 1, *, depth: int = 1,
                 window_ms: float = 2.0, window_size: int | None = None,
                 program_store: str | None = None,
                 mesh_dir: str | None = None,
                 max_outstanding: int = MAX_OUTSTANDING,
                 min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 respawn: bool = True,
                 faults: FaultPlan | str | None = None,
                 serve_kwargs: dict | None = None,
                 child_env: dict | None = None,
                 transport: str | object = "pipe",
                 worker_token: str | None = None,
                 shard_threshold: int | None = None,
                 gang_devices: int | None = None,
                 gang_comm: str = "fused",
                 cpus_per_replica: int | None = None,
                 registry: MetricsRegistry | None = None,
                 spawn_timeout_s: float = 180.0,
                 clock=time.monotonic,
                 tracer=None, trace_dir: str | None = None,
                 flight_dir: str | None = None,
                 stale_after_s: float = 60.0,
                 slo=None,
                 **engine_kwargs):
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if max_outstanding < 1:
            raise ValueError(
                f"max_outstanding must be >= 1, got {max_outstanding}")
        if isinstance(faults, str):
            faults = FaultPlan.parse(faults)
        # the sharded big-case tier: grids above the
        # threshold (in grid POINTS) go to the gang replica.  0 turns
        # the tier off per the repo's 0-knob convention.
        if shard_threshold is not None:
            shard_threshold = int(shard_threshold)
            if shard_threshold < 0:
                raise ValueError(
                    f"shard_threshold must be >= 0 (0/None = off), got "
                    f"{shard_threshold}")
            if shard_threshold == 0:
                shard_threshold = None
        self.shard_threshold = shard_threshold
        if gang_comm not in ("fused", "collective"):
            raise ValueError(
                f"gang_comm must be 'fused' or 'collective', got "
                f"{gang_comm!r}")
        self.gang_comm = gang_comm
        if gang_devices is not None and int(gang_devices) < 1:
            raise ValueError(
                f"gang_devices must be >= 1, got {gang_devices}")
        # None = the gang worker uses every card IT sees (the router
        # never touches the card)
        self.gang_devices = (int(gang_devices) if gang_devices is not None
                             else None)
        self._transport_arg = transport
        self._worker_token = worker_token
        self._transport = None  # constructed just before the spawns
        self.min_replicas = int(min_replicas if min_replicas is not None
                                else replicas)
        self.max_replicas = int(max_replicas if max_replicas is not None
                                else max(2 * replicas, replicas + 1))
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")
        self.max_outstanding = int(max_outstanding)
        self.respawn = bool(respawn)
        self.depth = int(depth)
        self.window_ms = float(window_ms)
        self.window_size = window_size
        self.program_store = program_store
        # the mesh registry dir (serve/meshes.py): every
        # worker resolves the SAME registry so a mesh-keyed bucket is
        # servable wherever the sticky router pins it (None = inherit
        # the ambient NLHEAT_MESH_DIR, the program_store convention)
        self.mesh_dir = mesh_dir
        self.serve_kwargs = dict(serve_kwargs or {})
        self.engine_kwargs = dict(engine_kwargs)
        self.child_env = dict(child_env or {})
        # CPU-affinity budget per worker (os.sched_setaffinity in the
        # child): the CPU proxy of per-replica hardware — one torch CPU
        # process otherwise spreads over every host core and a fleet
        # A/B on one box would measure contention, not scale-out.
        # None = no pinning (production: each replica owns its machine)
        self.cpus_per_replica = (int(cpus_per_replica)
                                 if cpus_per_replica else None)
        try:
            self._host_cpus = sorted(os.sched_getaffinity(0))
        except AttributeError:  # non-Linux: no pinning support
            self._host_cpus = []
            self.cpus_per_replica = None
        self.spawn_timeout_s = float(spawn_timeout_s)
        self._clock = clock
        self._faults = faults
        # fleet tracing: ``trace_dir`` turns on cross-process
        # tracing — the router runs its own span tracer (labeled for the
        # merged timeline) and every worker installs one too, writing
        # per-replica trace files under trace_dir; dump_fleet_trace()
        # merges them all into ONE Perfetto document.  Without it the
        # router inherits the process-global tracer (None = off, the
        # zero-cost path; TRACE_OFF forces off like ServePipeline).
        self.trace_dir = trace_dir
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            self._tracer = obs_trace.Tracer(label="router")
        else:
            self._tracer = (None if tracer is obs_trace.TRACE_OFF
                            else tracer if tracer is not None
                            else obs_trace.get_tracer())
        # crash flight recorder (obs/flightrec.py): the router's own
        # black box — worker death dumps a postmortem naming the killed
        # replica, its in-flight cases, and each re-route decision.
        # ``flight_dir`` explicit, else the ambient NLHEAT_FLIGHT_DIR
        # recorder if one is installed process-globally.
        if flight_dir is not None:
            self._flightrec = flightrec.FlightRecorder(flight_dir)
        else:
            self._flightrec = flightrec.get_recorder()
        self.flight_dir = (self._flightrec.dir
                           if self._flightrec is not None else None)
        # fleet-scrape staleness: absorb times per
        # replica; dead replicas' /replica{r} gauges are labeled stale
        # inside the window and DROPPED from the merged scrape after it
        self.stale_after_s = float(stale_after_s)
        self._absorb_t: dict[int, float] = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._m_cases = r.counter("/router/cases")
        self._m_routed = r.counter("/router/routed")  # forwards, requeues incl
        self._m_sharded = r.counter("/router/sharded-cases")
        self._m_picked = r.counter("/router/picked-cases")
        self._m_requeued = r.counter("/router/requeued")
        self._m_deaths = r.counter("/router/deaths")
        self._m_spawns = r.counter("/router/spawns")
        self._m_scale_ups = r.counter("/router/scale-ups")
        self._m_scale_downs = r.counter("/router/scale-downs")
        self._m_replicas = r.gauge("/router/replicas")
        self._m_outstanding = r.gauge("/router/outstanding")
        self._m_max_outstanding = r.gauge("/router/max-outstanding")
        self._m_max_outstanding.set(self.max_outstanding)
        self._m_buckets = r.gauge("/router/buckets")
        self._h_latency = r.histogram("/router/request-latency-ms")
        # the fleet SLO ledger (obs/slo.py): promises at
        # submit, outcomes at the result frame.  ``live=False`` — the
        # router never touches the card, so only
        # the WORKERS recalibrate rates; their /slo/* metrics ride the
        # stats-frame snapshots absorbed under /replica{r}/slo/*.
        self._slo = obs_slo.SloLedger.from_arg(
            slo, registry=self.registry, clock=clock, live=False)
        # the router's shared state is written from the caller's thread,
        # every per-replica reader thread, and the elastic scale loop;
        # the guarded_by annotations name the lock each field needs
        self._lock = threading.RLock()
        self._replicas: dict[int, _Replica] = {}  # guarded_by: self._lock
        #: every admitted-but-undelivered request, keyed by seq.  The
        #: per-replica ``outstanding`` maps are ROUTING state (who holds
        #: the case now) and go transiently empty while a death's
        #: orphans await re-routing; this map is the delivery ledger —
        #: only a result/error frame (or close) removes a request, so
        #: drain()/admission can never mistake mid-recovery for done.
        self._pending: dict[int, RouterRequest] = {}  # guarded_by: self._lock
        self._owner: dict = {}  # bucket key -> rid; guarded_by: self._lock
        self._next_rid = 0  # guarded_by: self._lock
        self._next_seq = 0  # guarded_by: self._lock
        self._closed = False  # guarded_by: self._lock
        self._telemetry = FleetTelemetry()
        self._policy = BusyRatePolicy(self._telemetry)
        if self._flightrec is not None:
            self._flightrec.bind(registry=self.registry,
                                 inflight=self._inflight_ledger)
        try:
            # transport construction may bind a listener: inside the
            # cleanup scope so a failed fleet boot cannot leak the port
            self._transport = make_transport(transport, token=worker_token)
            self._prebuild()
            for _ in range(replicas):
                self._spawn()
            if self.shard_threshold is not None:
                self._spawn(gang=True)
        except BaseException:
            self.close()
            raise

    # -- worker lifecycle ---------------------------------------------------
    def _prebuild(self) -> None:
        """One nvcc build per fleet: when the workers' device is the card,
        build every kernel library in THIS process before the first spawn
        (restored from the program store instead where this process has one
        on, ``NLHEAT_PROGRAM_STORE``), so no worker starts a compiler.
        nvcc needs no CUDA context, and nothing here creates one; a host
        without a card is refused here, in the words every entry point of
        the port uses."""
        if not _on_card(self.engine_kwargs):
            return
        from nonlocalheatequation_torch.ops import _build
        from nonlocalheatequation_torch.utils.devices import resolve_device

        resolve_device(self.engine_kwargs.get("device"))
        _build.build(_build.ALL_SOURCES)

    def _spawn(self, gang: bool = False) -> int:
        with self._lock:
            # concurrent spawns are real (a reader thread's respawn
            # racing add_replica): the id draw must be atomic
            rid = self._next_rid
            self._next_rid += 1
        env = dict(os.environ)
        # a router-level fault plan must not leak INTO the workers'
        # pipelines (the die kind is router vocabulary; raise/stall/nan
        # entries would double-inject) — worker-internal chaos goes
        # through serve_kwargs["faults"] deliberately
        env.pop("NLHEAT_FAULT_PLAN", None)
        # a leaked token must not outlive its transport: only the
        # socket transport re-injects it for its own children
        env.pop(WORKER_TOKEN_ENV, None)
        env[REPLICA_ID_ENV] = str(rid)
        env.update(self.child_env)
        handle = self._transport.spawn(rid, env,
                                       timeout_s=self.spawn_timeout_s)
        rep = _Replica(rid, handle, gang=gang)
        affinity = None
        if self.cpus_per_replica and self._host_cpus:
            k, cpus = self.cpus_per_replica, self._host_cpus
            start = (rid * k) % len(cpus)
            affinity = [cpus[(start + j) % len(cpus)] for j in range(k)]
        cfg = {
            "replica_id": rid,
            "depth": self.depth,
            "window_ms": self.window_ms,
            "window_size": self.window_size,
            "program_store": self.program_store,
            "mesh_dir": self.mesh_dir,
            "serve_kwargs": self.serve_kwargs,
            "engine_kwargs": self.engine_kwargs,
            "cpu_affinity": affinity,
            "trace_dir": self.trace_dir,
            "flight_dir": self.flight_dir,
            "transport": self._transport.name,
        }
        if gang:
            # the sharded-case worker: one N-device mesh, distributed
            # solves, comm='fused' where the kernel family serves it
            cfg["gang"] = {"devices": self.gang_devices,
                           "comm": self.gang_comm}
        with self._lock:
            self._replicas[rid] = rep
            self._m_replicas.set(self.live_count())
        self._m_spawns.inc()
        rep.send(cfg)
        threading.Thread(target=rep._writer, daemon=True,
                         name=f"nlheat-router-writer-{rid}").start()
        threading.Thread(target=self._reader, args=(rep,), daemon=True,
                         name=f"nlheat-router-reader-{rid}").start()
        if not rep.ready.wait(self.spawn_timeout_s):
            rep.closing = True
            handle.kill()
            raise RuntimeError(
                f"replica {rid} did not become ready within "
                f"{self.spawn_timeout_s:.0f}s")
        return rid

    def _reader(self, rep: _Replica) -> None:
        """Per-worker reader thread: parse response frames until EOF,
        then treat the EOF as a death (unless the router stopped the
        worker itself).  ``recv_frame`` returns None for EOF AND for
        any malformed/oversized/truncated length prefix or mid-frame
        disconnect (serve/transport.py) — a socket peer writing garbage
        classifies as replica death, never a router crash or a reader
        thread parked on a half-frame."""
        while True:
            try:
                msg = rep.handle.recv_frame()
            except Exception:  # noqa: BLE001 — torn frame == dead worker
                msg = None
            if msg is None:
                break
            self._on_message(rep, msg)
        self._on_eof(rep)

    def _inflight_ledger(self) -> list:
        """The flight recorder's in-flight snapshot: every undelivered
        case with its current owner (the postmortem's 'who held what'
        answer)."""
        try:
            with self._lock:
                return [{"case": req.seq, "replica": req.replica,
                         "requeues": req.requeues}
                        for req in self._pending.values()]
        except Exception:  # noqa: BLE001 — observability never raises
            return []

    def _on_message(self, rep: _Replica, msg: dict) -> None:
        op = msg.get("op")
        if op == "ready":
            rep.clock_sync = msg.get("clock_sync")
            rep.ready.set()
        elif op == "trace":
            # a pulled fleet-trace dump: deliver to its waiter (same
            # token mechanism as stats, without touching last_stats)
            waiter = rep.stats_waiters.pop(msg.get("id"), None)
            if waiter is not None:
                waiter[1].append(msg)
                waiter[0].set()
        elif op in ("result", "error"):
            with self._lock:
                req = rep.outstanding.get(msg["id"])
                if req is None:  # late frame for a requeued case: the
                    return  # survivor's copy owns delivery (no dupes)
            # assign BEFORE removing from the ledgers: a drain()/waiter
            # that observes the ledger empty must find the result (or
            # error) already in place, never a half-delivered request
            if op == "result":
                req.result = msg["values"]
            else:
                req.error = ServeError(
                    msg.get("classification", "error"), req.seq,
                    msg.get("chunk", -1), msg.get("attempts", 0),
                    msg.get("detail", ""))
            req.latency_s = self._clock() - req.submit_t
            with self._lock:
                rep.outstanding.pop(msg["id"], None)
                self._pending.pop(msg["id"], None)
                self._m_outstanding.set(self.outstanding_total())
            self._h_latency.observe(req.latency_s * 1e3)
            if self._slo is not None:
                # the promise/outcome join: exactly once per case — the
                # delivery ledger above already dropped late frames for
                # re-routed cases, so a duplicate here would be a
                # regression the ledger's /slo/duplicate counter names
                self._slo.resolve(
                    req.seq, latency_s=req.latency_s,
                    error=(None if op == "result"
                           else msg.get("classification", "error")))
            req.done.set()
        elif op == "stats":
            waiter = rep.stats_waiters.pop(msg.get("id"), None)
            rep.last_stats = msg
            if waiter is not None:
                waiter[1].append(msg)
                waiter[0].set()

    def _on_eof(self, rep: _Replica) -> None:
        with self._lock:
            rep.alive = False
            self._m_replicas.set(self.live_count())
        rep.sendq.put(None)  # release the writer thread
        # EOF means exit is imminent; reap the zombie (and close every
        # pipe/socket stream) either way — no fd leaks under chaos
        rep.handle.reap(timeout_s=10)
        with self._lock:
            if rep.closing or self._closed:
                self._replicas.pop(rep.rid, None)
                return
            self._m_deaths.inc()
            orphans = list(rep.outstanding.values())
            rep.outstanding.clear()
            buckets = set(rep.buckets)
            rep.buckets.clear()
            for key in buckets:
                if self._owner.get(key) == rep.rid:
                    del self._owner[key]
            self._telemetry.forget(rep.rid)
            self._replicas.pop(rep.rid, None)  # dead entries never
            # accumulate across a long fleet's chaos history
        print(f"router: replica {rep.rid} died with "
              f"{len(orphans)} case(s) in flight; re-routing",
              file=sys.stderr)
        fr = self._flightrec
        decisions: list = []
        if fr is not None:
            fr.record("replica-death", replica=rep.rid,
                      orphans=[r.seq for r in orphans],
                      buckets_orphaned=len(buckets))
        # release any stats pull blocked on the dead worker
        for token in list(rep.stats_waiters):
            waiter = rep.stats_waiters.pop(token, None)
            if waiter is not None:
                waiter[0].set()
        if rep.gang:
            # the gang replica is the ONLY worker that can serve the
            # sharded case class: respawn it regardless of the small-
            # fleet floor, or its orphans re-route into a refusal
            if self.respawn and self.shard_threshold is not None:
                try:
                    self._spawn(gang=True)
                except Exception as e:  # noqa: BLE001
                    print(f"router: gang respawn after replica "
                          f"{rep.rid} death failed ({e})",
                          file=sys.stderr)
        elif self.respawn and self.live_count() < self.min_replicas:
            try:
                self._spawn()
            except Exception as e:  # noqa: BLE001 — survivors still serve
                print(f"router: respawn after replica {rep.rid} death "
                      f"failed ({e}); continuing with "
                      f"{self.live_count()} replica(s)", file=sys.stderr)
        for req in orphans:
            req.requeues += 1
            self._m_requeued.inc()
            if req.requeues > MAX_REQUEUES:
                # the fleet-level quarantine: a case still in flight
                # after MAX_REQUEUES deaths is treated as the killer
                print(f"router: case {req.seq} survived "
                      f"{MAX_REQUEUES} replica deaths; quarantining",
                      file=sys.stderr)
                with self._lock:
                    self._pending.pop(req.seq, None)
                req.error = ServeError("error", req.seq, -1,
                                       req.requeues,
                                       "re-routed past MAX_REQUEUES "
                                       "(replica-killing case?)")
                if self._slo is not None:
                    self._slo.resolve(
                        req.seq, latency_s=self._clock() - req.submit_t,
                        error="replica-death")
                req.done.set()
                decisions.append({"case": req.seq, "action": "quarantine",
                                  "requeues": req.requeues})
                continue
            try:
                try:
                    self._route(req)
                except RouterOverloaded:
                    # a death cannot lose work to backpressure: the hard
                    # cap bounds CALLER intake, not recovery — force
                    self._route(req, force=True)
                decisions.append({"case": req.seq, "action": "re-route",
                                  "replica": req.replica,
                                  "requeues": req.requeues})
            except Exception as e:  # noqa: BLE001 — e.g. no live
                # replicas after a failed respawn: the request must
                # complete EXCEPTIONALLY, never hang a waiter, and the
                # remaining orphans must still get their turn
                print(f"router: re-route of case {req.seq} failed "
                      f"({e}); completing exceptionally", file=sys.stderr)
                with self._lock:
                    self._pending.pop(req.seq, None)
                req.error = ServeError("error", req.seq, -1, 0,
                                       f"re-route failed: {e}")
                if self._slo is not None:
                    self._slo.resolve(
                        req.seq, latency_s=self._clock() - req.submit_t,
                        error="re-route-failed")
                req.done.set()
                decisions.append({"case": req.seq, "action": "failed",
                                  "detail": str(e)})
        if fr is not None:
            # the black box: killed replica, its in-flight cases, and
            # the re-route decision for each (a die@ plan must leave
            # this postmortem)
            for d in decisions:
                fr.record("re-route", **d)
            fr.dump("replica-death", replica=rep.rid,
                    orphans=[r.seq for r in orphans],
                    decisions=decisions)

    # -- routing ------------------------------------------------------------
    def live_count(self) -> int:
        """Live SMALL-CASE replicas — the fleet the sticky buckets,
        elastic policy, and min/max floors govern.  The gang replica is
        a different case class and is counted by :meth:`gang_live`."""
        return sum(1 for r in self._replicas.values()
                   if r.alive and not r.gang)

    def gang_live(self) -> int:
        return sum(1 for r in self._replicas.values()
                   if r.alive and r.gang)

    def is_sharded(self, shape) -> bool:
        """Does a grid of ``shape`` belong to the sharded big-case
        class?  2D grids above ``shard_threshold`` POINTS; other ranks
        keep the replica path (the distributed gang solver is the
        2D flagship — the reference's own top tier).  PUBLIC because
        the ingress picker gates its candidate axis on the SAME
        predicate (serve/http.py — an fft pick must never route to the
        gang, whose halo-padded blocks the spectral embedding cannot
        serve); one predicate, no drift."""
        if self.shard_threshold is None:
            return False
        try:
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError):
            return False
        return (len(shape) == 2
                and int(np.prod(shape)) > self.shard_threshold)

    def _is_sharded(self, case) -> bool:
        return self.is_sharded(getattr(case, "shape", None))

    def sharded_fft_capability(self, shape, eps: int) -> bool:
        """Can the gang serve a SHARDED case of ``shape`` with
        method='fft' (the pencil-decomposed transform,
        ops/spectral_sharded.py)?  The ingress picker reads this to
        decide the candidate axis for gang-bound cases.  Pure host
        arithmetic: the gang's mesh is predicted with
        ``choose_mesh_shape`` from ``gang_devices``, so the router
        never touches the card.  ``gang_devices``
        None means the worker sizes its own mesh from devices the
        router cannot see — the capability is then unknown and the
        answer is the conservative False (the stencil axis always
        serves)."""
        if self.gang_devices is None:
            return False
        try:
            shape = tuple(int(s) for s in shape)
        except (TypeError, ValueError):
            return False
        if len(shape) != 2:
            return False
        from nonlocalheatequation_torch.ops.spectral_sharded import (
            supports_sharded_fft,
        )
        from nonlocalheatequation_torch.parallel.distributed2d import (
            choose_mesh_shape,
        )

        mesh_shape = choose_mesh_shape(shape[0], shape[1],
                                       self.gang_devices)
        return supports_sharded_fft(shape, int(eps), mesh_shape)

    def _gang_rep(self) -> _Replica:
        for r in self._replicas.values():
            if r.gang and r.alive:
                return r
        raise RuntimeError(
            "router has no live gang replica for a sharded case")

    def outstanding_total(self) -> int:
        return len(self._pending)

    def retry_after_s(self) -> float:
        """Suggested backoff for a shed request: the observed p50
        request latency (one service time frees one slot), floored so a
        cold fleet never advertises zero."""
        pct = self._h_latency.percentiles()
        return max(0.05, pct.get("p50", 0.0) / 1e3)

    def _pick_replica(self) -> _Replica:
        live = [r for r in self._replicas.values()
                if r.alive and r.ready.is_set() and not r.draining
                and not r.gang]
        if not live:
            live = [r for r in self._replicas.values()
                    if r.alive and not r.gang]
        if not live:
            raise RuntimeError("router has no live replicas")
        return min(live, key=lambda r: (len(r.buckets),
                                        len(r.outstanding), r.rid))

    def submit(self, case: EnsembleCase, *, deadline_ms: float | None = None,
               priority: int = 0, trace=None,
               engine=None, sticky_key=None) -> RouterRequest:
        """Route one case; returns its handle.  Raises
        :class:`RouterOverloaded` when the fleet's bounded in-flight
        budget is exhausted (the ingress tier turns that into 429).
        ``trace`` is the ingress-minted TraceContext; a traced router
        mints one itself for direct (non-HTTP) submissions so the fleet
        timeline still chains every span to a request identity.
        ``engine`` is a picked engine (serve/picker.py
        ``EngineChoice``): it rides the case frame — a pipeline worker
        serves the case from its engine pool, the gang worker threads
        the picked stepper/method through ``solve_case_sharded`` — so
        BOTH case classes honor the pick; None is the fleet default.
        ``sticky_key`` overrides the ROUTING identity (the session
        tier's long-lived placement key, serve/sessions.py); it changes
        which replica owns the case, never what the worker computes."""
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            req = RouterRequest(case, self._next_seq, self._clock())
            req.deadline_ms = deadline_ms
            req.priority = int(priority)
            if sticky_key is not None:
                req.sticky_key = tuple(sticky_key)
            if engine is not None:
                req.engine = engine
                self._m_picked.inc()
            if trace is not None:
                req.trace = trace if isinstance(trace, TraceContext) \
                    else TraceContext.from_wire(trace)
            elif self._tracer is not None:
                req.trace = TraceContext.mint(request=self._next_seq)
                req.trace_minted = True  # the router IS the trace root
            if req.trace is not None and req.trace.request is None:
                req.trace.request = self._next_seq
            self._next_seq += 1
            self._pending[req.seq] = req
            self._m_cases.inc()
        # the pipe write happens OUTSIDE the router lock (_route's own
        # lock covers only the bookkeeping): a full worker stdin pipe
        # must never block the reader threads' result delivery
        try:
            self._route(req)
        except BaseException:
            # a shed (or any routing failure) must not leak the request
            # in the delivery ledger — a leaked entry would consume
            # in-flight capacity forever and hang drain()
            with self._lock:
                self._pending.pop(req.seq, None)
            raise
        if self._slo is not None:
            # promise AFTER the route sticks: a shed request (429 at
            # the ingress tier) never becomes an SLO promise, so burn
            # measures promises the fleet actually accepted
            self._slo.promise(req.seq, engine=req.engine,
                              deadline_ms=req.deadline_ms,
                              mesh=getattr(req.case, "mesh", None),
                              t=req.submit_t)
        return req

    def _route(self, req: RouterRequest, force: bool = False) -> None:
        with self._lock:
            cap = self.max_outstanding * max(
                1, self.live_count() + self.gang_live())
            outstanding = self.outstanding_total()
            if outstanding >= cap and not force:
                raise RouterOverloaded(outstanding, cap,
                                       self.retry_after_s())
            if self._is_sharded(req.case):
                # the sharded case class: one space-parallel solve on
                # the gang replica's mesh — no sticky bucket (the gang
                # is a singleton; its solver cache is keyed worker-side)
                rep = self._gang_rep()
                if req.requeues == 0:
                    self._m_sharded.inc()
            else:
                key = (req.sticky_key if req.sticky_key is not None
                       else req.case.bucket_key())
                rid = self._owner.get(key)
                rep = self._replicas.get(rid) if rid is not None else None
                if rep is None or not rep.alive or rep.draining:
                    rep = self._pick_replica()
                    self._owner[key] = rep.rid
                    rep.buckets.add(key)
                    self._m_buckets.set(len(self._owner))
            req.replica = rep.rid
            rep.outstanding[req.seq] = req
            self._m_outstanding.set(self.outstanding_total())
            fired = (self._faults.draw([req.seq])
                     if self._faults is not None else None)
        tr = self._tracer
        if tr is not None and req.trace is not None:
            # the router-dispatch hop of the request's flow chain: one
            # instant + one flow STEP at a single clock read (tracing-on
            # only; the untraced path takes zero extra clock reads)
            now = self._clock()
            tr.instant("router.dispatch", ts=now, cat="router",
                       case=req.seq, replica=rep.rid,
                       requeue=req.requeues, trace=req.trace.trace_id)
            # the flow chain's router hop: a router-minted trace (no
            # ingress) roots the chain HERE ("start"); an ingress-rooted
            # one (or any re-route) continues it ("step")
            phase = ("start" if req.trace_minted and not req._flow_started
                     else "step")
            req._flow_started = True
            tr.flow("request", phase, req.trace.trace_id, ts=now,
                    cat="router", req=req.seq, replica=rep.rid)
        sent = rep.send({"op": "case", "id": req.seq, "case": req.case,
                         "deadline_ms": req.deadline_ms,
                         "priority": req.priority,
                         # the picked engine rides the frame (wire dict,
                         # not the dataclass — frames stay plain data)
                         "engine": (req.engine.wire()
                                    if req.engine is not None else None),
                         "trace": (req.trace.to_wire()
                                   if req.trace is not None else None)})
        self._m_routed.inc()
        if fired is not None and fired.die is not None:
            # the deterministic worker-kill: the __kill__ sentinel rides
            # the same send queue, so the case frame lands first — the
            # case IS in flight on rep when the SIGKILL does, and the
            # reader's EOF re-routes it (utils/faults.py "die")
            print(f"router: fault plan fired {fired.die.describe()} — "
                  f"killing replica {rep.rid}", file=sys.stderr)
            rep.send({"op": "__kill__"})
        elif not sent:
            # the pipe broke under us: the reader's EOF path re-routes
            # this case with everything else that was outstanding there
            pass

    # -- completion ---------------------------------------------------------
    def wait(self, req: RouterRequest,
             timeout: float | None = None) -> np.ndarray:
        return req.wait(timeout)

    def drain(self, timeout_s: float = 600.0) -> None:
        """Block until every outstanding case is delivered (deaths
        re-route, so a draining fleet converges as long as one replica
        can be kept alive)."""
        deadline = self._clock() + timeout_s
        while True:
            with self._lock:
                pending = list(self._pending.values())
            if not pending:
                return
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"router drain: {len(pending)} case(s) still in "
                    f"flight after {timeout_s:.0f}s")
            pending[0].done.wait(timeout=0.2)

    def serve_cases(self, cases) -> list:
        """Submit every case, drain, return results in submission order
        (None for a quarantined case — its handle carries the
        ServeError), the router twin of ``ServePipeline.serve_cases``."""
        handles = [self.submit(c) for c in cases]
        self.drain()
        return [h.result for h in handles]

    # -- elasticity ---------------------------------------------------------
    def add_replica(self) -> int:
        """Scale out by one worker and rebalance bucket ownership toward
        it: the newcomer inherits a fair share of existing buckets from
        the most-loaded owners (ownership is a cache-warmth heuristic,
        never a correctness rule — any replica serves any bucket
        bit-identically), which it warm-boots from the shared program
        store instead of re-tracing."""
        rid = self._spawn()
        with self._lock:
            rep = self._replicas[rid]
            donors = sorted(
                (r for r in self._replicas.values()
                 if r.alive and r.rid != rid and not r.gang),
                key=lambda r: -len(r.buckets))
            want = len(self._owner) // max(1, self.live_count())
            for donor in donors:
                while len(rep.buckets) < want and donor.buckets \
                        and len(donor.buckets) > len(rep.buckets):
                    key = next(iter(donor.buckets))
                    donor.buckets.discard(key)
                    rep.buckets.add(key)
                    self._owner[key] = rid
        return rid

    def drain_replica(self, rid: int, timeout_s: float = 600.0) -> None:
        """Scale in: stop routing NEW work to ``rid``, reassign its
        buckets, let its in-flight cases finish, then stop the worker."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or not rep.alive:
                return
            if rep.gang:
                raise ValueError(
                    "cannot drain the gang replica: it is the only "
                    "worker serving the sharded case class (set "
                    "shard_threshold=None to retire the tier)")
            if self.live_count() <= 1:
                raise ValueError(
                    "cannot drain the last live replica; add one first")
            rep.draining = True
            for key in list(rep.buckets):
                rep.buckets.discard(key)
                if self._owner.get(key) == rid:
                    del self._owner[key]
        deadline = self._clock() + timeout_s
        while rep.outstanding:
            if self._clock() >= deadline:
                raise TimeoutError(
                    f"replica {rid} still has {len(rep.outstanding)} "
                    f"case(s) in flight after {timeout_s:.0f}s")
            with self._lock:
                pending = next(iter(rep.outstanding.values()), None)
            if pending is not None:
                pending.done.wait(timeout=0.2)
        rep.closing = True
        rep.send({"op": "stop"})
        rep.sendq.put(None)  # writer exits after flushing the stop
        rep.handle.reap(timeout_s=30)
        self._telemetry.forget(rid)
        with self._lock:
            self._m_replicas.set(self.live_count())

    def _pull(self, op: str, timeout_s: float) -> dict:
        """Broadcast one request frame (``stats``/``trace``) to every
        live ready worker and collect the reply frames — the shared
        token/waiter mechanism.  A failed send drops its waiter
        immediately (never left for the death path to sweep).  Returns
        ``{replica_handle: reply_frame}`` for the workers that
        answered within ``timeout_s``."""
        waiters = []
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.alive and r.ready.is_set()]
        for rep in live:
            with self._lock:
                token = self._next_seq  # shares the seq space: unique
                self._next_seq += 1
            ev, box = threading.Event(), []
            rep.stats_waiters[token] = [ev, box]
            if rep.send({"op": op, "id": token}):
                waiters.append((rep, ev, box))
            else:
                rep.stats_waiters.pop(token, None)
        out = {}
        deadline = self._clock() + timeout_s
        for rep, ev, box in waiters:
            ev.wait(max(0.0, deadline - self._clock()))
            if box:
                out[rep] = box[0]
        return out

    def refresh_stats(self, timeout_s: float = 30.0) -> dict:
        """Pull one stats window from every live worker: per-replica
        metrics/snapshots (absorbed into the router registry under
        ``/replica{r}`` names) and the busy fractions feeding
        :meth:`maybe_scale`.  Returns ``{rid: stats_frame}``."""
        out = {}
        for rep, stats in self._pull("stats", timeout_s).items():
            out[rep.rid] = stats
            if not rep.gang:
                # the gang replica serves a different case class: its
                # busy window must not veto (min-aggregation) or force
                # small-fleet scale decisions
                self._telemetry.record_window(
                    rep.rid, stats.get("busy_s", 0.0),
                    stats.get("span_s", 0.0))
                self.registry.gauge(
                    f"/replica{{{rep.rid}}}/busy-rate").set(
                    round(self._telemetry.rate(rep.rid), 3))
            snap = stats.get("snapshot")
            if snap:
                absorb_snapshot(self.registry, f"/replica{{{rep.rid}}}",
                                snap)
                self._absorb_t[rep.rid] = self._clock()
                self.registry.gauge(
                    f"/replica{{{rep.rid}}}/stale").set(0)
        self._prune_stale_replicas()
        return out

    def _prune_stale_replicas(self) -> None:
        """Fleet-scrape staleness: a dead/drained
        replica's absorbed ``/replica{r}/...`` gauges are point-in-time
        copies that would otherwise linger in the merged ``/metrics``
        scrape forever.  Inside the window the replica is LABELED
        (``/replica{r}/stale`` = 1); past ``stale_after_s`` without a
        fresh absorb its whole namespace is DROPPED."""
        now = self._clock()
        with self._lock:
            live = {r.rid for r in self._replicas.values() if r.alive}
        for rid, t in list(self._absorb_t.items()):
            if rid in live:
                continue
            if now - t >= self.stale_after_s:
                self.registry.drop_prefix(f"/replica{{{rid}}}")
                del self._absorb_t[rid]
            else:
                self.registry.gauge(f"/replica{{{rid}}}/stale").set(1)

    def arm_steady_state(self) -> None:
        """Broadcast the rebuild watchdog arm to
        every live worker: after warm-up a steady-state fleet should
        build ZERO new programs — each worker's ServePipeline counts and
        warns loudly on post-arm ``programs_built`` growth."""
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.alive and r.ready.is_set()]
        for rep in live:
            rep.send({"op": "arm"})

    def maybe_scale(self) -> str | None:
        """One elastic step: pull stats, run the factored busy-rate
        policy (parallel/elastic.py), actuate.  Returns "add"/"drain"
        when the fleet changed, else None."""
        self.refresh_stats()
        busy = self._policy.window_rates()
        decision = fleet_scale_decision(
            busy, self.live_count(), n_min=self.min_replicas,
            n_max=self.max_replicas)
        if decision == "add":
            self._m_scale_ups.inc()
            self.add_replica()
        elif decision == "drain":
            with self._lock:
                live = [r for r in self._replicas.values()
                        if r.alive and not r.gang]
                # drain the emptiest worker (fewest buckets, then fewest
                # in-flight) — the cheapest ownership reassignment
                victim = min(live, key=lambda r: (len(r.buckets),
                                                  len(r.outstanding)))
            self._m_scale_downs.inc()
            self.drain_replica(victim.rid)
        self._policy.reset()
        return decision

    # -- observability ------------------------------------------------------
    def dump_fleet_trace(self, path: str,
                         timeout_s: float = 30.0) -> dict | None:
        """Pull every live worker's span ring over the frame channel,
        align the per-process clocks (each worker's tracer carries the
        monotonic/wall pair exchanged on its hello frame), and write ONE
        Perfetto-loadable Chrome trace at ``path`` — pid = replica id,
        the router's own spans alongside, request flow events intact
        (obs/trace.py merge_chrome_traces).  Returns a summary dict
        ``{path, processes, events}`` or None when nothing could be
        written (loud, never raises — a failed trace dump must not kill
        the fleet it observed)."""
        try:
            docs = []
            if self._tracer is not None:
                docs.append(self._tracer.chrome_trace())
            for rep, msg in self._pull("trace", timeout_s).items():
                doc = msg.get("doc")
                if not doc:
                    continue
                # clock alignment belt-and-braces: a pulled doc
                # normally carries its tracer's clock_sync; if not,
                # fall back to the pair this worker exchanged on its
                # hello frame (the handshake the merge relies on)
                meta = doc.setdefault("metadata", {})
                if not meta.get("clock_sync") and rep.clock_sync:
                    meta["clock_sync"] = dict(rep.clock_sync)
                docs.append(doc)
            if not docs:
                print("router: dump_fleet_trace found no tracers "
                      "(construct the router with trace_dir=...)",
                      file=sys.stderr)
                return None
            merged = merge_chrome_traces(docs)
            if not write_chrome_trace(merged, path):
                return None
            return {"path": path, "processes": len(docs),
                    "events": len(merged["traceEvents"])}
        except Exception as e:  # noqa: BLE001 — observability never raises
            print(f"router: dump_fleet_trace failed ({e!r})",
                  file=sys.stderr)
            return None

    def metrics(self) -> dict:
        with self._lock:
            live = [r.rid for r in self._replicas.values()
                    if r.alive and not r.gang]
            gang = [r.rid for r in self._replicas.values()
                    if r.alive and r.gang]
            per_replica = {
                r.rid: {"outstanding": len(r.outstanding),
                        "buckets": len(r.buckets), "alive": r.alive,
                        "draining": r.draining, "gang": r.gang}
                for r in self._replicas.values()}
        out = {
            "replicas": len(live),
            "live": live,
            "gang": gang,
            "transport": self._transport.name if self._transport else None,
            "shard_threshold": self.shard_threshold,
            "sharded_cases": self._m_sharded.value,
            "cases": self._m_cases.value,
            "routed": self._m_routed.value,
            "requeued": self._m_requeued.value,
            "deaths": self._m_deaths.value,
            "spawns": self._m_spawns.value,
            "scale_ups": self._m_scale_ups.value,
            "scale_downs": self._m_scale_downs.value,
            "outstanding": self.outstanding_total(),
            "max_outstanding": self.max_outstanding,
            "buckets": len(self._owner),
            "request_latency_ms": self._h_latency.percentiles(),
            "per_replica": per_replica,
        }
        if self._slo is not None:
            out["slo"] = self._slo.summary()
        return out

    def close(self) -> None:
        """Stop the fleet.  Outstanding handles complete exceptionally
        (a closed router must never leave a waiter blocked forever)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = list(self._replicas.values())
        for rep in reps:
            rep.closing = True
            if rep.alive:
                rep.send({"op": "stop"})
            rep.sendq.put(None)  # writer exits after flushing the stop
        for rep in reps:
            rep.handle.reap(timeout_s=30)
            rep.outstanding.clear()
        if self._transport is not None:
            self._transport.close()
        # the delivery ledger: anything still undelivered completes
        # exceptionally — a closed router must never leave a waiter
        # blocked (orphans mid-re-route included)
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for req in pending:
            if not req.done.is_set():
                req.error = ServeError("error", req.seq, -1, 0,
                                       "router closed")
                if self._slo is not None:
                    # no open promises left behind: the chaos-consistency
                    # test asserts promised == resolved after close
                    self._slo.resolve(
                        req.seq, latency_s=self._clock() - req.submit_t,
                        error="router-closed")
                req.done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def router_load_ab(engine_kwargs: dict, cases, replicas: int,
                   store_dir: str | None, *, window_ms: float = 2.0,
                   overload_factor: float = 2.0,
                   overload_pending: int | None = None,
                   cpus_per_replica: int | None = None,
                   child_env: dict | None = None) -> dict:
    """The fleet measurement a benchmark calls: serve the SAME case set
    through a 1-replica and an N-replica router over ONE shared program
    store dir (the single-replica arm populates it, the fleet arm
    warm-boots — spawn cost stays honest but build cost does not
    multiply), then re-offer the cases at ``overload_factor`` x the
    fleet's measured capacity through a tightly-budgeted admission gate
    — the overload-honesty half: the gate must SHED (429-shaped) rather
    than queue without bound, and the accepted requests' p99 must stay
    near the unloaded p99.  Returns the walls, the speedup, both
    arms' results (callers pin bit-identity), and the offered-load
    accounting."""
    from nonlocalheatequation_torch.serve.http import (
        AdmissionController,
        offered_load_run,
    )

    cases = list(cases)
    if cpus_per_replica is None:
        # the CPU proxy of per-replica hardware: EVERY worker — the
        # 1-replica arm's included — gets the same fixed core budget
        # (one torch CPU process otherwise spreads over the whole host
        # and the A/B measures intra-op threading, not fleet scale-out)
        try:
            cpus_per_replica = max(
                1, len(os.sched_getaffinity(0)) // max(2, replicas))
        except AttributeError:
            cpus_per_replica = None
    if len({c.bucket_key() for c in cases}) < replicas:
        # sticky routing pins a bucket to ONE replica: a case set with
        # fewer buckets than replicas cannot scale out BY DESIGN, and a
        # silently meaningless A/B must not bank numbers
        raise ValueError(
            f"router A/B needs >= {replicas} distinct buckets (got "
            f"{len({c.bucket_key() for c in cases})}): sticky routing "
            "cannot spread one bucket over the fleet")
    walls: dict[int, float] = {}
    results: dict[int, list] = {}
    unloaded_lat: dict = {}
    arms = [1, replicas] if replicas != 1 else [1]
    for n in arms:
        with ReplicaRouter(replicas=n, program_store=store_dir,
                           window_ms=window_ms, child_env=child_env,
                           cpus_per_replica=cpus_per_replica,
                           **engine_kwargs) as router:
            # pass 1 warms (and, arm 1, populates the shared store);
            # pass 2 is the steady-state wall the speedup and the
            # offered-load capacity are computed from — program
            # build/load time must not masquerade as serving capacity
            results[n] = router.serve_cases(cases)
            t0 = time.perf_counter()
            router.serve_cases(cases)
            walls[n] = time.perf_counter() - t0
            if n == replicas:
                # pass-2 samples ONLY: pass 1's first-case latencies
                # carry the store loads, and an inflated "unloaded"
                # baseline would flatter the overload p99 comparison
                hist = router.registry.get("/router/request-latency-ms")
                tail = list(hist.samples)[-len(cases):]
                unloaded_lat = {
                    "p50": float(np.percentile(tail, 50)),
                    "p90": float(np.percentile(tail, 90)),
                    "p99": float(np.percentile(tail, 99)),
                }
    # offered-load sweep over ONE admission-gated fleet (programs warm
    # from the store): a rate-based point at overload_factor x the
    # measured capacity, then a burst point (no pacing at all — offered
    # rate >> capacity by construction, so the shed path is exercised
    # deterministically, not only when the capacity estimate is tight)
    capacity_hz = len(cases) / walls[replicas]
    sweep: dict[str, dict] = {}
    with ReplicaRouter(replicas=replicas, program_store=store_dir,
                       window_ms=window_ms, child_env=child_env,
                       cpus_per_replica=cpus_per_replica,
                       **engine_kwargs) as router:
        adm = AdmissionController(
            router,
            max_pending=(overload_pending if overload_pending is not None
                         else max(2, 2 * replicas)))
        for label, rate in ((f"x{overload_factor:g}",
                             overload_factor * capacity_hz),
                            ("burst", 0.0)):
            run = offered_load_run(adm, cases + cases, rate)
            run.pop("results", None)
            run["rate_hz"] = round(rate, 3)
            sweep[label] = run
    return {
        "walls": walls,
        "speedup": walls[1] / walls[replicas],
        "capacity_hz": capacity_hz,
        "results": results,
        "unloaded_latency_ms": {k: round(v, 3)
                                for k, v in unloaded_lat.items()},
        "sweep": sweep,
    }


def router_traced_ab(engine_kwargs: dict, cases, replicas: int,
                     store_dir: str | None, trace_dir: str, *,
                     window_ms: float = 2.0,
                     cpus_per_replica: int | None = None,
                     child_env: dict | None = None) -> dict:
    """The fleet observability A/B a benchmark calls: serve the SAME case
    set through two N-replica routers over ONE shared program store dir — once untraced (TRACE_OFF forced, the
    zero-cost disabled path even under an ambient global tracer: the
    serve_traced_ab discipline at fleet altitude) and once with
    cross-process tracing on (router tracer + per-worker tracers +
    trace frames + flow events).  Each arm runs a warm pass (arm 1
    populates the store; arm 2 warm-boots) then a timed pass, so the
    ratio isolates the tracing cost, not builds.  The traced arm arms
    the rebuild watchdog after its warm pass (a steady-state fleet must
    build zero new programs) and dumps the merged fleet trace.  Returns
    walls, the overhead ratio (<= 1.05 is the tracing gate at fleet
    altitude), both arms' results (callers pin bit-identity), the
    merged-trace summary, and the span count."""
    cases = list(cases)
    if cpus_per_replica is None:
        # the same CPU proxy as router_load_ab: every worker in both
        # arms gets one fixed core budget, so the ratio measures
        # tracing cost, not thread-placement luck
        try:
            cpus_per_replica = max(
                1, len(os.sched_getaffinity(0)) // max(2, replicas))
        except AttributeError:
            cpus_per_replica = None
    walls: dict[str, float] = {}
    results: dict[str, list] = {}
    merged = None
    spans_total = 0
    steady = 0
    for arm in ("untraced", "traced"):
        kw = (dict(trace_dir=trace_dir) if arm == "traced"
              else dict(tracer=obs_trace.TRACE_OFF))
        with ReplicaRouter(replicas=replicas, program_store=store_dir,
                           window_ms=window_ms, child_env=child_env,
                           cpus_per_replica=cpus_per_replica, **kw,
                           **engine_kwargs) as router:
            results[arm] = router.serve_cases(cases)  # warm pass
            if arm == "traced":
                router.arm_steady_state()
            t0 = time.perf_counter()
            router.serve_cases(cases)
            walls[arm] = time.perf_counter() - t0
            if arm == "traced":
                merged = router.dump_fleet_trace(
                    os.path.join(trace_dir, "fleet_trace.json"))
                # the fleet-wide span count: every process's events in
                # the merged timeline (falls back to the router's own
                # ring if the merge could not be written)
                spans_total = (merged["events"] if merged else
                               router._tracer.spans_total
                               if router._tracer is not None else 0)
                # the rebuild watchdog's verdict: armed after the warm
                # pass, so a steady-state fleet reports 0 here (a pull
                # absorbs each worker's counter under /replica{r}/...)
                router.refresh_stats()
                steady = 0
                for name in router.registry.names():
                    if name.endswith("/store/steady-state-builds"):
                        steady += int(router.registry.get(name).value)
    return {
        "walls": walls,
        "trace_overhead": walls["traced"] / walls["untraced"],
        "results": results,
        "merged": merged,
        "spans_total": spans_total,
        "steady_state_builds": steady,
    }


def router_slo_ab(engine_kwargs: dict, cases, replicas: int,
                  store_dir: str | None, *, window_ms: float = 2.0,
                  deadline_ms: float = 60_000.0,
                  corrupt_factor: float = 1e3,
                  cpus_per_replica: int | None = None,
                  child_env: dict | None = None) -> dict:
    """The SLO-audit overhead + drift A/B a benchmark calls: serve the
    SAME case set through two N-replica routers over ONE shared program
    store dir, once UNAUDITED
    (``slo=False`` router-side, ``NLHEAT_SLO=0`` in every worker: the
    one-attribute-read disabled path) and once AUDITED (fleet ledger on
    the router, per-worker ledgers in every pipeline).  Each arm runs a
    warm pass then a timed pass, so ``slo_overhead`` isolates the
    ledger cost (the <= 1.05 gate, the tracing bar).

    Both arms submit each case with an explicit :class:`EngineChoice`
    matching the fleet's default engine (same compute, bit-identical
    results) whose ``est_ms`` is SELF-CALIBRATED from the audited arm's
    warm-pass latencies — the modeled-vs-observed ratio of the clean
    timed pass is ~1 by construction, so the drift detector must stay
    quiet (``drift_fired_clean``).  A third pass re-offers the cases
    with ``est_ms`` divided by ``corrupt_factor`` — an injected
    cost-model corruption the detector MUST flag
    (``drift_fired_corrupt``), the acceptance pair.  ``deadline_ms`` is
    generous: an unloaded fleet's ``deadline_hit_rate`` must read
    1.0."""
    cases = list(cases)
    if cpus_per_replica is None:
        # the same CPU proxy as router_load_ab: every worker in both
        # arms gets one fixed core budget so the ratio measures ledger
        # cost, not thread-placement luck
        try:
            cpus_per_replica = max(
                1, len(os.sched_getaffinity(0)) // max(2, replicas))
        except AttributeError:
            cpus_per_replica = None

    def default_choice(case, est_ms: float) -> EngineChoice:
        # the fleet default engine's settings as an explicit pick: the
        # worker serves it from the same pool entry it would use for an
        # engine-less submission, so the audited/unaudited results stay
        # bit-identical and only the promise metadata differs
        return EngineChoice(
            stepper=str(engine_kwargs.get("stepper", "euler")),
            stages=int(engine_kwargs.get("stages", 0) or 0),
            method=str(engine_kwargs.get("method", "auto")),
            precision=str(engine_kwargs.get("precision", "f32")),
            dt=float(case.dt), steps=int(case.nt),
            est_ms=float(est_ms), est_err=0.0, rates="measured")

    def run_pass(router, scale: float, est: dict) -> float:
        # the submit loop is INSIDE the timed wall: promise() runs at
        # submit, and hiding it outside t0 would flatter the overhead
        t0 = time.perf_counter()
        handles = [router.submit(
            c, deadline_ms=deadline_ms,
            engine=default_choice(c, est[i] * scale))
            for i, c in enumerate(cases)]
        router.drain()
        wall = time.perf_counter() - t0
        for h in handles:
            if h.error is not None:
                raise h.error
        return wall

    walls: dict[str, float] = {}
    results: dict[str, list] = {}
    slo_summary: dict = {}
    drift_clean = drift_corrupt = 0
    for arm in ("unaudited", "audited"):
        audited = arm == "audited"
        env = dict(child_env or {})
        env["NLHEAT_SLO"] = "1" if audited else "0"
        # the workers' own ledgers run for overhead realism, but their
        # drift windows compare DEVICE ms against the e2e-calibrated
        # est_ms this harness injects — not the modeled-vs-observed
        # pair under test.  The router-level detector is the gated
        # surface; park the worker band out of the way.
        env.setdefault("NLHEAT_SLO_BAND", "1e-9,1e9")
        with ReplicaRouter(replicas=replicas, program_store=store_dir,
                           window_ms=window_ms, child_env=env,
                           cpus_per_replica=cpus_per_replica,
                           slo=audited,
                           **engine_kwargs) as router:
            # pass 1 warms (and, arm 1, populates the shared store);
            # pass 2 calibrates the per-case modeled cost from STEADY
            # latencies (warm-pass latencies carry store loads and
            # would skew the clean drift window); pass 3 is the timed
            # wall the overhead ratio reads
            warm = [router.submit(c, deadline_ms=deadline_ms)
                    for c in cases]
            router.drain()
            results[arm] = [h.result for h in warm]
            cal = [router.submit(c, deadline_ms=deadline_ms)
                   for c in cases]
            router.drain()
            est = {i: max(1e-3, (h.latency_s or 0.0) * 1e3)
                   for i, h in enumerate(cal)}
            walls[arm] = run_pass(router, 1.0, est)
            if audited:
                s = router.metrics()["slo"]
                drift_clean = int(s["drift_warnings"])
                slo_summary = s
                # the injected corruption: the same cases promised at
                # est_ms / corrupt_factor — observed/modeled leaves the
                # band and the detector must warn exactly here
                run_pass(router, 1.0 / corrupt_factor, est)
                drift_corrupt = int(
                    router.metrics()["slo"]["drift_warnings"])
    return {
        "walls": walls,
        "slo_overhead": walls["audited"] / walls["unaudited"],
        "results": results,
        "slo": slo_summary,
        "deadline_hit_rate": slo_summary.get("deadline_hit_rate"),
        "drift_fired_clean": drift_clean > 0,
        "drift_fired_corrupt": drift_corrupt > drift_clean,
    }


def fleet_tcp_ab(engine_kwargs: dict, cases, replicas: int,
                 store_dir: str | None, *, shard_cases=(),
                 shard_threshold: int | None = None,
                 gang_devices: int | None = None,
                 window_ms: float = 2.0, overload_factor: float = 2.0,
                 overload_pending: int | None = None,
                 cpus_per_replica: int | None = None,
                 child_env: dict | None = None) -> dict:
    """The fleet-transport measurement a benchmark calls — two halves in
    one harness:

    1. **pipe vs loopback-TCP A/B**: the SAME case set served by an
       N-replica router over in-process pipes and again over the
       socket transport, both arms warm-booting from ONE shared program
       store dir (the pipe arm populates it).  ``tcp_overhead`` is the
       steady-pass wall ratio — the per-frame cost of the socket hop,
       with results pinned bit-identical across transports.
    2. **mixed small+sharded offered-load sweep**: a TCP fleet with
       the gang tier enabled serves an interleaved stream of small
       cases (sticky-bucket replicas) and sharded big cases (the gang
       replica's N-device mesh), paced at ``overload_factor`` x the
       measured capacity and then as one burst through the admission
       gate — queues must stay bounded (shed, not grow), sharded
       results must come back bit-identical to the offline
       ``solve_case_sharded`` oracle, and small cases must keep their
       fleet speedup.

    Returns walls, ``tcp_overhead``, both arms' results, the sharded
    oracle comparison, and the sweep accounting."""
    from nonlocalheatequation_torch.parallel.gang import solve_case_sharded
    from nonlocalheatequation_torch.serve.http import (
        AdmissionController,
        offered_load_run,
    )

    cases = list(cases)
    shard_cases = list(shard_cases)
    if cpus_per_replica is None:
        # the same CPU proxy as router_load_ab: every worker in both
        # arms gets one fixed core budget so the transport ratio
        # measures framing+wire cost, not thread-placement luck
        try:
            cpus_per_replica = max(
                1, len(os.sched_getaffinity(0)) // max(2, replicas))
        except AttributeError:
            cpus_per_replica = None
    if len({c.bucket_key() for c in cases}) < replicas:
        raise ValueError(
            f"fleet A/B needs >= {replicas} distinct buckets (got "
            f"{len({c.bucket_key() for c in cases})}): sticky routing "
            "cannot spread one bucket over the fleet")
    walls: dict[str, float] = {}
    results: dict[str, list] = {}
    # pipe vs tcp at fleet size, plus a 1-replica TCP arm so the fleet
    # speedup over sockets is MEASURED (not assumed from the pipe A/B);
    # every arm's workers get the same per-replica core budget
    arms = [("pipe", replicas), ("tcp", replicas)]
    if replicas != 1:
        arms.append(("tcp1", 1))
    for arm, n in arms:
        with ReplicaRouter(replicas=n,
                           transport="pipe" if arm == "pipe" else "tcp",
                           program_store=store_dir, window_ms=window_ms,
                           child_env=child_env,
                           cpus_per_replica=cpus_per_replica,
                           **engine_kwargs) as router:
            # pass 1 warms (and, arm pipe, populates the shared store);
            # pass 2 is the steady wall the overhead ratio reads
            results[arm] = router.serve_cases(cases)
            t0 = time.perf_counter()
            router.serve_cases(cases)
            walls[arm] = time.perf_counter() - t0
    out = {
        "walls": walls,
        "tcp_overhead": walls["tcp"] / walls["pipe"],
        "fleet_speedup": walls.get("tcp1", walls["tcp"]) / walls["tcp"],
        "capacity_hz": len(cases) / walls["tcp"],
        "results": results,
    }
    if shard_cases and shard_threshold is None:
        # everything offered as "small" stays small; everything in
        # shard_cases lands above the line
        shard_threshold = max(int(np.prod(c.shape)) for c in cases)
    # the offline sharded oracle: THIS process, same devices/env the
    # gang worker inherits — the bit-identity half of the case class
    ocache: dict = {}
    oracle = [solve_case_sharded(
        c, ndevices=gang_devices, comm="fused",
        method=engine_kwargs.get("method", "auto"),
        precision=engine_kwargs.get("precision", "f32"),
        dtype=engine_kwargs.get("dtype"), solver_cache=ocache,
        device=engine_kwargs.get("device"))
        for c in shard_cases]
    # interleave sharded cases through the small stream so both case
    # classes are concurrently in flight (the composition under test);
    # with no shard cases the sweep still runs — transport-only mode
    mixed: list = []
    stride = max(1, len(cases) // max(1, len(shard_cases) or 1))
    si = iter(shard_cases)
    for i, c in enumerate(cases):
        mixed.append(c)
        if i % stride == stride - 1:
            mixed.extend([s for s in [next(si, None)] if s is not None])
    mixed.extend(si)
    sweep: dict[str, dict] = {}
    with ReplicaRouter(replicas=replicas, transport="tcp",
                       shard_threshold=(shard_threshold if shard_cases
                                        else None),
                       gang_devices=gang_devices,
                       program_store=store_dir, window_ms=window_ms,
                       child_env=child_env,
                       cpus_per_replica=cpus_per_replica,
                       **engine_kwargs) as router:
        got = router.serve_cases(mixed)  # warm pass + identity capture
        by_case = {id(c): v for c, v in zip(mixed, got, strict=True)}
        small_ok = all(
            by_case[id(c)] is not None
            and np.array_equal(by_case[id(c)], w)
            for c, w in zip(cases, results["tcp"], strict=True))
        shard_ok = all(
            by_case[id(c)] is not None
            and np.array_equal(by_case[id(c)], w)
            for c, (w, _info) in zip(shard_cases, oracle, strict=True))
        if not (small_ok and shard_ok):
            # name the failing HALF: a bare false bit-identity flag is
            # undiagnosable from the one-line JSON
            def _why(v, w):
                if v is None:
                    return "no result"
                return f"max diff {float(np.abs(v - w).max())!r}"

            for i, (c, w) in enumerate(zip(cases, results["tcp"], strict=True)):
                v = by_case[id(c)]
                if v is None or not np.array_equal(v, w):
                    print(f"fleet_tcp_ab: mixed small case {i} deviates "
                          f"from the tcp arm ({_why(v, w)})",
                          file=sys.stderr)
            for i, (c, (w, _)) in enumerate(zip(shard_cases, oracle, strict=True)):
                v = by_case[id(c)]
                if v is None or not np.array_equal(v, w):
                    print(f"fleet_tcp_ab: sharded case {i} deviates "
                          f"from the offline oracle ({_why(v, w)})",
                          file=sys.stderr)
        adm = AdmissionController(
            router,
            max_pending=(overload_pending if overload_pending is not None
                         else max(2, 2 * replicas)))
        rate = overload_factor * out["capacity_hz"]
        for label, r in ((f"x{overload_factor:g}", rate), ("burst", 0.0)):
            run = offered_load_run(adm, mixed + mixed, r)
            run.pop("results", None)
            run["rate_hz"] = round(r, 3)
            sweep[label] = run
        out["sharded_cases"] = router.metrics()["sharded_cases"]
    out["sharded"] = ({
        "cases": len(shard_cases),
        "threshold": shard_threshold,
        "info": oracle[0][1],
        "bit_identical": shard_ok,
    } if shard_cases else None)
    out["mixed_bit_identical"] = small_ok and shard_ok
    out["sweep"] = sweep
    return out


# -- the worker process -------------------------------------------------------


def _gang_loop(cfg: dict, out, poll, eof, tracer, trace_dir,
               ready_frame) -> None:
    """The sharded-case worker loop: each ``case`` frame is ONE whole
    space-parallel distributed solve over this worker's N-device mesh
    (parallel/gang.py ``solve_case_sharded`` — the same adapter the
    offline oracle calls, which is what makes the streamed-back result
    bit-identical to the offline ``Solver2DDistributed`` run).  Solves
    are synchronous — a gang replica is one case at a time by design
    (the mesh IS the parallelism) — so the frame channel drains between
    cases; ``stats``/``trace``/``stop`` frames queued behind a solve
    answer when it retires, inside the router's pull timeouts.  Busy
    accounting (wall time inside solves per stats window) feeds the
    fleet scrape exactly like the pipeline workers', but the router
    keeps gang windows OUT of the small-fleet scale policy."""
    from nonlocalheatequation_torch.obs.metrics import REGISTRY
    from nonlocalheatequation_torch.parallel.gang import solve_case_sharded

    gang = cfg.get("gang") or {}
    rid = cfg.get("replica_id")
    ek = cfg.get("engine_kwargs") or {}
    # solves run on a dedicated thread so the frame loop stays LIVE
    # mid-solve: a minutes-long sharded case must not leave the
    # router's stats/trace pulls stalling to their timeouts (the fleet
    # scrape would silently lose the gang on exactly the long cases
    # this tier exists for).  Writes to the frame channel are
    # serialized — two threads interleaving a frame would tear the
    # protocol.
    wlock = threading.Lock()

    def send(frame) -> None:
        with wlock:
            _write_frame(out, frame)

    slock = threading.Lock()  # covers the shared solve accounting
    state = {"served": 0, "busy_s": 0.0, "comm": {}, "solvers": 0,
             "active_t0": None}
    caseq: "queue.Queue" = queue.Queue()
    solver_cache: dict = {}

    def solve_loop() -> None:
        while True:
            msg = caseq.get()
            if msg is None:
                return
            t0 = time.monotonic()
            with slock:
                state["active_t0"] = t0
            ctx = TraceContext.from_wire(msg.get("trace"))
            prev = obs_trace.set_context(ctx)
            try:
                with obs_trace.span("gang.solve", cat="gang",
                                    case=msg.get("id")):
                    # the picked engine (serve/picker.py) overrides the
                    # fleet defaults per case — the sharded class honors
                    # the pick too, fft/expo picks included:
                    # solve_case_sharded serves them on the pencil-
                    # decomposed spectral tier (a fused-comm gang falls
                    # back to the collective transposes via its
                    # ValueError fallback, recorded in info)
                    pe = msg.get("engine") or {}
                    values, info = solve_case_sharded(
                        msg["case"],
                        ndevices=gang.get("devices"),
                        comm=gang.get("comm", "fused"),
                        method=pe.get("method",
                                      ek.get("method", "auto")),
                        precision=pe.get("precision",
                                         ek.get("precision", "f32")),
                        dtype=ek.get("dtype"),
                        device=ek.get("device"),
                        stepper=pe.get("stepper",
                                       ek.get("stepper", "euler")),
                        stages=int(pe.get("stages",
                                          ek.get("stages", 0) or 0)),
                        solver_cache=solver_cache)
                with slock:
                    state["served"] += 1
                    state["comm"][info["comm"]] = \
                        state["comm"].get(info["comm"], 0) + 1
                    state["solvers"] = len(solver_cache)
                send({"op": "result", "id": msg["id"],
                      "values": values, "sharded": info})
            except Exception as e:  # noqa: BLE001 — an unservable
                # sharded case completes EXCEPTIONALLY, never kills
                # the gang worker (the fleet's only big-case server);
                # a failure on the card ends the worker instead: the
                # router sees the death and re-routes the case
                _end_on_card_failure(e, ek, rid)
                try:
                    send({"op": "error", "id": msg["id"],
                          "classification": "error", "chunk": -1,
                          "attempts": 0,
                          "detail": f"sharded solve refused: "
                                    f"{type(e).__name__}: {e}"})
                except (OSError, ValueError):
                    return  # channel gone: the router owns recovery
            finally:
                obs_trace.set_context(prev)
                with slock:
                    state["busy_s"] += time.monotonic() - t0
                    state["active_t0"] = None

    solver = threading.Thread(target=solve_loop, daemon=True,
                              name="nlheat-gang-solver")
    solver.start()
    window_t0 = time.monotonic()
    send(ready_frame())
    stopping = False
    while not stopping:
        for msg in poll(0.05):
            op = msg.get("op")
            if op == "case":
                caseq.put(msg)  # one solve at a time, frame loop live
            elif op == "stats":
                now = time.monotonic()
                with slock:
                    busy_s = state["busy_s"]
                    state["busy_s"] = 0.0
                    if state["active_t0"] is not None:
                        # credit the IN-FLIGHT solve's window share: a
                        # gang mid-long-case must read busy, not idle
                        # (a boundary-spanning solve can double-count
                        # its pre-window slice; the telemetry clamps
                        # busy/span at 1 and the gang is excluded from
                        # the scale policy — observability-grade)
                        busy_s += now - max(window_t0,
                                            state["active_t0"])
                    metrics = {"cases": state["served"], "gang": True,
                               "devices": gang.get("devices"),
                               "comm": dict(state["comm"]),
                               "solvers": state["solvers"]}
                send({
                    "op": "stats", "id": msg.get("id"), "replica": rid,
                    "pid": os.getpid(), "gang": True,
                    "metrics": metrics,
                    # the gang's halo traffic lands in the process
                    # registry (/halo/bytes, /halo/exchanges) — absorbed
                    # under /replica{r} like the pipeline workers'
                    "snapshot": REGISTRY.snapshot(),
                    "busy_s": busy_s, "span_s": now - window_t0,
                })
                window_t0 = now
            elif op == "trace":
                send({
                    "op": "trace", "id": msg.get("id"), "replica": rid,
                    "doc": (tracer.chrome_trace() if tracer is not None
                            else None)})
            elif op == "stop":
                stopping = True
        if eof():
            stopping = True
    # drain: finish (and deliver) every accepted case before the bye —
    # the gang twin of the pipe worker's pipe.drain() at stop
    caseq.put(None)
    solver.join()
    if tracer is not None and trace_dir:
        tracer.write(os.path.join(trace_dir,
                                  f"host_trace.replica{rid}.json"))
    try:
        send({"op": "bye"})
    except OSError:
        pass


def _on_card(engine_kwargs: dict) -> bool:
    """The worker's engine runs on the card (``device`` None: the default
    card, as every entry point of the port)."""
    dev = engine_kwargs.get("device")
    return dev is None or str(dev).split(":")[0] in ("cuda", "gpu")


def _end_on_card_failure(exc: BaseException, engine_kwargs: dict, rid) -> None:
    """End this worker when ``exc`` is a real failure on the card: with the
    engine on the card, an exception that is neither an injected fault nor
    a refusal of the case (ValueError/TypeError) is not classified and
    never served from the CPU.  The process exits at once; the router sees
    the EOF, counts a death and re-routes the worker's cases."""
    from nonlocalheatequation_torch.utils.faults import InjectedFault

    if not _on_card(engine_kwargs) or isinstance(exc, (InjectedFault, ValueError, TypeError)):
        return
    print(f"replica {rid}: failure on the card, ending the worker: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
    os._exit(70)


def _worker_main(connect: str | None = None, frame_fd: int | None = None) -> None:
    """The replica worker: one ServePipeline fed by framed stdin — or,
    with ``connect="host:port"`` (the ``--worker-connect`` CLI form), by
    a TCP socket it DIALS into the router's transport listener, sending
    a JSON hello (replica id + ``NLHEAT_WORKER_TOKEN``) before the
    first pickle frame (serve/transport.py trust boundary).

    Pipe mode writes its frames to the ORIGINAL fd 1, which the module
    took before torch was imported (``frame_fd``: a caller that runs this
    function in a process of its own takes fd 1 the same way and passes
    the duplicate; with neither, it is taken here); socket mode leaves
    stdio alone.  Either way the worker points ``NLHEAT_PROGRAM_STORE``
    at the shared store, builds its pipeline with the router's engine
    kwargs (``device``/``dtype``), then loops: poll the frame fd, submit
    arriving cases, pump the pipeline, and — whenever the intake is
    momentarily idle with work outstanding — drain, so results flow
    without the caller-driven fences the in-process pipeline relies on.
    Results are host NumPy arrays.  The loop accounts its busy wall (time
    inside pump/drain with work outstanding) per stats window; the router
    turns that into the fleet's busy rates.  With the engine on the card a
    real failure propagates out of the pipeline and ends the worker (the
    router re-routes); a refused submission completes exceptionally.  A
    ``gang`` config block switches the worker to the sharded-case loop
    instead (:func:`_gang_loop`)."""
    sock = None
    if connect is None:
        if frame_fd is None:
            frame_fd = _FRAME_FD
        if frame_fd is None:
            frame_fd = os.dup(1)
            os.dup2(2, 1)
        out = os.fdopen(frame_fd, "wb")
        fd = sys.stdin.fileno()
    else:
        import socket as _socket

        host, _, port = connect.rpartition(":")
        sock = _socket.create_connection((host or "127.0.0.1", int(port)))
        out = sock.makefile("wb")
        fd = sock.fileno()
        rid_env = os.environ.get(REPLICA_ID_ENV)
        write_json_frame(out, {
            "op": "hello",
            "replica": int(rid_env) if rid_env else None,
            "token": os.environ.get(WORKER_TOKEN_ENV)})
    # all frame-channel reads go through ONE raw-fd buffer: a
    # BufferedReader's read-ahead on the config frame could swallow the
    # front of the next frame and tear the protocol
    buf = bytearray()
    eof = False

    def read_blocking_frame():
        nonlocal eof
        while True:
            while len(buf) >= _LEN.size:
                n = _LEN.unpack(bytes(buf[:_LEN.size]))[0]
                if n > MAX_FRAME_BYTES:
                    eof = True  # a lying prefix: die cleanly, never
                    return None  # allocate the lie
                if len(buf) < _LEN.size + n:
                    break
                payload = bytes(buf[_LEN.size:_LEN.size + n])
                del buf[:_LEN.size + n]
                return pickle.loads(payload)
            if eof:
                return None
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
            else:
                buf.extend(chunk)

    cfg = read_blocking_frame()
    if cfg is None:
        return
    if cfg.get("cpu_affinity"):
        try:
            # before the pipeline exists, so every torch pool thread
            # inherits the budget (threads created later inherit the
            # process affinity)
            os.sched_setaffinity(0, set(cfg["cpu_affinity"]))
        except (AttributeError, OSError) as e:
            print(f"replica {cfg.get('replica_id')}: cpu affinity "
                  f"{cfg['cpu_affinity']} not applied ({e})",
                  file=sys.stderr)
    store = cfg.get("program_store")
    if store is not None:
        os.environ["NLHEAT_PROGRAM_STORE"] = str(store)
    mesh_dir = cfg.get("mesh_dir")
    if mesh_dir is not None:
        os.environ["NLHEAT_MESH_DIR"] = str(mesh_dir)
    rid = cfg.get("replica_id")
    ek = cfg.get("engine_kwargs") or {}
    # fleet tracing: a traced router hands every worker a trace_dir —
    # install the process-global tracer (so pipeline/ensemble/store
    # spans all record) before the pipeline constructs; the ring is
    # written per-replica at exit and pulled live by the "trace" op
    tracer = None
    trace_dir = cfg.get("trace_dir")
    if trace_dir:
        tracer = obs_trace.Tracer(label=f"replica {rid}", replica=rid)
        obs_trace.set_tracer(tracer)
    # crash flight recorder: per-worker black box (quarantines, breaker
    # opens, SIGTERM all dump; SIGKILL death is the ROUTER's dump)
    flight_dir = cfg.get("flight_dir")
    if flight_dir:
        rec = flightrec.FlightRecorder(flight_dir, replica=rid)
        flightrec.set_recorder(rec)
        flightrec.install_sigterm(rec)

    def poll(timeout: float) -> list:
        """Read every frame currently available (waiting up to
        ``timeout`` for the first byte)."""
        nonlocal eof
        frames = []
        wait = timeout
        while not eof:
            r, _, _ = select.select([fd], [], [], wait)
            if not r:
                break
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
                break
            buf.extend(chunk)
            wait = 0.0
        while len(buf) >= _LEN.size:
            n = _LEN.unpack(bytes(buf[:_LEN.size]))[0]
            if n > MAX_FRAME_BYTES:
                eof = True  # lying prefix: die cleanly (the router
                break  # classifies the EOF as a death)
            if len(buf) < _LEN.size + n:
                break
            payload = bytes(buf[_LEN.size:_LEN.size + n])
            del buf[:_LEN.size + n]
            frames.append(pickle.loads(payload))
        return frames

    def ready_frame() -> dict:
        return {"op": "ready", "replica": rid,
                # the clock-offset handshake: this worker's
                # (monotonic, wall) pair, matching its tracer's
                # span timestamps — the router merges on it
                "clock_sync": (tracer.clock_sync if tracer
                               is not None else
                               {"monotonic": time.monotonic(),
                                "wall": time.time()})}

    if cfg.get("gang"):
        # the sharded-case worker: no ServePipeline — one N-device
        # mesh, whole distributed solves per case frame
        _gang_loop(cfg, out, poll, lambda: eof, tracer, trace_dir,
                   ready_frame)
        return
    from nonlocalheatequation_torch.serve.server import ServePipeline

    pipe = ServePipeline(depth=cfg.get("depth", 1),
                         window_ms=cfg.get("window_ms", 2.0),
                         window_size=cfg.get("window_size"),
                         **cfg.get("serve_kwargs") or {},
                         **ek)
    _write_frame(out, ready_frame())

    outstanding: dict[int, object] = {}
    busy_s = 0.0
    window_t0 = time.monotonic()

    def flush_done() -> None:
        for rid_, h in list(outstanding.items()):
            if h.result is not None:
                _write_frame(out, {"op": "result", "id": rid_,
                                   "values": np.asarray(h.result)})
            elif h.error is not None:
                e = h.error
                _write_frame(out, {
                    "op": "error", "id": rid_,
                    "classification": e.classification,
                    "chunk": e.chunk_id, "attempts": e.attempts,
                    "detail": str(e)})
            else:
                continue
            del outstanding[rid_]

    stopping = False
    while not stopping:
        frames = poll(0.002 if outstanding else 0.05)
        got_case = False
        for msg in frames:
            op = msg.get("op")
            if op == "case":
                try:
                    h = pipe.submit(msg["case"],
                                    deadline_ms=msg.get("deadline_ms"),
                                    priority=msg.get("priority") or 0,
                                    trace=TraceContext.from_wire(
                                        msg.get("trace")),
                                    # picked engine (serve/picker.py):
                                    # served from the pipeline's pool
                                    engine=EngineChoice.from_wire(
                                        msg.get("engine")))
                except Exception as e:  # noqa: BLE001 — a malformed
                    # case must complete EXCEPTIONALLY, not kill the
                    # worker (a poison frame would otherwise crash-loop
                    # the fleet through death -> re-route -> death); a
                    # pipeline a card failure ended is not a poison
                    # frame: the worker ends and the router re-routes
                    if pipe._failed is not None:
                        raise
                    _write_frame(out, {
                        "op": "error", "id": msg["id"],
                        "classification": "error", "chunk": -1,
                        "attempts": 0,
                        "detail": f"submit refused: "
                                  f"{type(e).__name__}: {e}"})
                    continue
                outstanding[msg["id"]] = h
                got_case = True
            elif op == "stats":
                now = time.monotonic()
                _write_frame(out, {
                    "op": "stats", "id": msg.get("id"),
                    "replica": cfg.get("replica_id"),
                    "pid": os.getpid(),
                    "metrics": pipe.metrics(),
                    "snapshot": pipe.registry.snapshot(),
                    "busy_s": busy_s,
                    "span_s": now - window_t0,
                })
                busy_s = 0.0
                window_t0 = now
            elif op == "trace":
                # the fleet-trace pull: ship this worker's span ring
                # (with its clock_sync metadata) back over the frame
                # channel for the router's merge
                _write_frame(out, {
                    "op": "trace", "id": msg.get("id"), "replica": rid,
                    "doc": (tracer.chrome_trace() if tracer is not None
                            else None)})
            elif op == "arm":
                pipe.arm_steady_state()
            elif op == "stop":
                stopping = True
        if eof:
            stopping = True
        if stopping:
            break
        t0 = time.monotonic()
        pipe.pump()
        if outstanding and not got_case and not buf:
            # intake momentarily idle with work queued: flush partial
            # windows and fence in-flight chunks so results ship now —
            # the worker-side stand-in for the in-process caller's
            # wait()/drain() fences
            pipe.drain()
        if outstanding:
            busy_s += time.monotonic() - t0
        flush_done()
    try:
        pipe.drain()
        flush_done()
        pipe.close()
    except Exception:  # noqa: BLE001 — dying cleanly beats a stack trace
        pass
    if tracer is not None and trace_dir:
        # the per-replica trace artifact (NLHEAT_REPLICA_ID in the
        # path): loadable standalone, or merged with the others
        tracer.write(os.path.join(trace_dir,
                                  f"host_trace.replica{rid}.json"))
    try:
        _write_frame(out, {"op": "bye"})
    except OSError:
        pass


if __name__ == "__main__":
    import argparse

    _ap = argparse.ArgumentParser(
        description="replica worker child (started by ReplicaRouter; "
                    "--worker-connect dials a SocketTransport listener "
                    "instead of speaking frames over stdin/stdout)")
    _ap.add_argument(
        "--worker-connect", default=None, metavar="HOST:PORT",
        help="dial the router's socket transport at HOST:PORT, send the "
             "JSON hello (replica id from NLHEAT_REPLICA_ID, token from "
             "NLHEAT_WORKER_TOKEN), then serve the identical frames the "
             "pipe workers speak")
    _worker_main(connect=_ap.parse_args().worker_connect)
