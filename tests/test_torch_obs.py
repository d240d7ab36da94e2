"""The port's observability tier (nonlocalheatequation_torch/obs/) on the CPU,
mirroring tests/test_obs.py and held against the JAX package.

What these tests pin, in float64:

* the span tracer's ring buffer (capacity bounds memory, oldest evicted,
  ``spans_total`` lifetime-exact), the span context manager, the no-op
  disabled path and the never-raises contract;
* a GOLDEN Chrome trace for a 2-chunk pipelined serve with one injected
  retry on an injected clock — the exact (ph, name) event sequence, as the
  JAX pipeline emits it;
* the chaos run under a tracer: retries, bisection, the breaker cycle and
  fallback chunks are visible, and the Prometheus text + JSON snapshot agree
  with ``ServeReport.metrics()`` on every shared counter;
* the registry: name grammar, one-name-one-kind, windows with
  lifetime-exact counts, and Prometheus/JSON expositions BYTE-EQUAL to the
  JAX registry's after the same updates;
* ``merge_chrome_traces`` equal to the JAX merge, a JSONL event log read
  back by the JAX ``read_jsonl`` unchanged, ``TraceContext`` wire forms;
* the exporters: the 127.0.0.1 scrape endpoint, the ``NLHEAT_EVENT_LOG``
  stream.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.obs import export as texport
from nonlocalheatequation_torch.obs import metrics as tmetrics
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.export import EventLog, serve_metrics
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.obs.trace import NULL_SPAN, Tracer
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils.faults import FaultPlan
from nonlocalheatequation_tpu.obs import export as jexport
from nonlocalheatequation_tpu.obs import metrics as jmetrics
from nonlocalheatequation_tpu.obs import trace as jtrace
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import server as jserver
from nonlocalheatequation_tpu.utils import faults as jfaults

torch.set_num_threads(1)

NX, NY, EPS, NSTEPS = 16, 16, 2, 2


def _cases(n, rng, nt=NSTEPS):
    return [EnsembleCase(shape=(NX, NY), nt=nt, eps=EPS, k=1.0, dt=1e-4, dh=0.02, test=False,
                         u0=rng.normal(size=(NX, NY))) for _ in range(n)]


def _engine(**kw):
    return EnsembleEngine(device="cpu", **kw)


class TickClock:
    """Strictly-increasing injected clock: every read advances 1 ms, so span
    timestamps are deterministic without wall-clock racing."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


class StepClock:
    """Manually-advanced clock (the breaker-cooldown tests)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _check_schema(events):
    """Chrome trace-event schema: the fields Perfetto keys on."""
    assert events, "no events recorded"
    for ev in events:
        assert ev["ph"] in ("X", "i", "C"), ev
        assert isinstance(ev["name"], str) and ev["name"]
        assert isinstance(ev["cat"], str) and ev["cat"]
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        assert isinstance(ev["pid"], int)
        assert isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] in ("t", "p", "g")


# -- tracer unit behavior ---------------------------------------------------
def test_ring_buffer_evicts_oldest_and_keeps_exact_lifetime_count():
    clock = TickClock()
    tr = Tracer(capacity=4, clock=clock)
    for i in range(10):
        t0 = clock()
        tr.complete(f"e{i}", t0)
    assert len(tr) == 4  # bounded
    assert [ev["name"] for ev in tr.events] == ["e6", "e7", "e8", "e9"]
    assert tr.spans_total == 10  # lifetime-exact through eviction
    doc = tr.chrome_trace()
    assert set(doc) == {"traceEvents", "displayTimeUnit", "metadata"}
    assert "clock_sync" in doc["metadata"]
    _check_schema(doc["traceEvents"])


def test_tracer_capacity_must_be_positive():
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_span_context_manager_records_error_and_timing():
    clock = TickClock()
    tr = Tracer(clock=clock)
    with tr.span("ok", cat="t", detail=1):
        pass
    with pytest.raises(RuntimeError):
        with tr.span("boom", cat="t"):
            raise RuntimeError("x")
    ok, boom = tr.events
    assert ok["name"] == "ok" and ok["args"] == {"detail": 1}
    assert ok["dur"] == pytest.approx(1000.0)  # one 1 ms tick, in us
    assert boom["args"]["error"] == "RuntimeError"


def test_disabled_path_is_the_shared_noop_span():
    assert obs_trace.get_tracer() is None  # the suite default
    assert obs_trace.span("anything", cat="x", a=1) is NULL_SPAN
    obs_trace.instant("anything")  # no tracer: silently dropped


def test_recording_never_raises_on_a_poisoned_clock():
    def bad_clock():
        raise RuntimeError("clock down")

    tr = Tracer(clock=bad_clock)
    with tr.span("s"):  # enter + exit both read the clock
        pass
    tr.instant("i")
    tr.counter("c", v=1)
    assert tr.spans_total == 0
    tr.complete("caller-timed", 0.0, 1.0)  # caller timestamps still land
    assert tr.spans_total == 1


def test_write_failure_returns_false_never_raises(tmp_path, capsys):
    tr = Tracer()
    tr.complete("e", 0.0, 1.0)
    assert tr.write(str(tmp_path)) is False  # a directory: open() fails
    assert "trace write" in capsys.readouterr().err
    out = tmp_path / "t.json"
    assert tr.write(str(out)) is True
    _check_schema(json.load(open(out))["traceEvents"])


# -- the golden pipelined-serve trace ---------------------------------------
def _golden_run(pipe_cls, engine, cases, plan):
    clock = TickClock()
    tracer = (Tracer if pipe_cls is ServePipeline else jtrace.Tracer)(clock=clock, pid=7)
    with pipe_cls(engine=engine, depth=2, window_ms=0.0, clock=clock, retries=1,
                  backoff_ms=1.0, sleep=lambda s: None, faults=plan, tracer=tracer) as pipe:
        for c in cases:
            pipe.submit(c)
        pipe.drain()
    return pipe, list(tracer.events)


def test_golden_trace_two_chunk_pipelined_serve_with_one_retry():
    """Deterministic spans for a 2-chunk pipelined serve with one injected
    retry, on an injected clock — and the JAX pipeline's trace of the same
    run has the same events in the same order with the same arguments."""
    rng = np.random.default_rng(0)
    cases = _cases(2, rng)
    pipe, events = _golden_run(ServePipeline, _engine(batch_sizes=(1,)), cases,
                               FaultPlan.parse("raise@1"))
    _check_schema(events)
    # chunk 0 dispatches clean; chunk 1's first attempt raises, retries,
    # dispatches; both are IN FLIGHT together; then two fetches
    assert [(ev["ph"], ev["name"]) for ev in events] == [
        ("i", "serve.close"),      # chunk 0 closes (size trigger)
        ("X", "serve.build"),      # chunk 0 pad/build/stage
        ("i", "serve.dispatch"),   # chunk 0 launch
        ("C", "serve.inflight"),   # 1 in flight
        ("i", "serve.close"),      # chunk 1 closes
        ("X", "serve.build"),      # chunk 1 attempt 1: injected raise
        ("i", "serve.retry"),      # classified + retried
        ("X", "serve.build"),      # chunk 1 attempt 2
        ("i", "serve.dispatch"),
        ("C", "serve.inflight"),   # 2 in flight — pipelining is real
        ("X", "serve.fetch"),      # chunk 0 retires (the due fence)
        ("C", "serve.inflight"),
        ("X", "serve.fetch"),      # chunk 1 retires
        ("C", "serve.inflight"),
    ]
    assert events[5]["args"]["error"] == "InjectedFault"
    assert events[6]["args"] == {"chunk": 1, "attempt": 1, "classification": "error",
                                 "backoff_ms": 1.0}
    assert events[7]["args"] == {"chunk": 1, "attempt": 2}
    assert [ev["args"]["inflight"] for ev in events if ev["ph"] == "C"] == [1, 2, 1, 0]
    assert all(ev["pid"] == 7 for ev in events)
    ts = [ev["ts"] for ev in events]
    assert ts == sorted(ts) and ts[0] > 0
    assert len(events) == 14
    assert pipe.report.retries == 1
    jcases = [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                                test=False, u0=c.u0) for c in cases]
    _, jevents = _golden_run(jserver.ServePipeline, jens.EnsembleEngine(batch_sizes=(1,)),
                             jcases, jfaults.FaultPlan.parse("raise@1"))
    assert [(e["ph"], e["name"], e.get("args")) for e in events] == \
        [(e["ph"], e["name"], e.get("args")) for e in jevents]


def test_bisection_and_quarantine_are_visible_as_spans():
    clock = TickClock()
    tracer = Tracer(clock=clock)
    rng = np.random.default_rng(3)
    engine = _engine(batch_sizes=(8,))
    with ServePipeline(engine=engine, depth=1, window_ms=10_000.0, clock=clock, retries=0,
                       backoff_ms=0.0, fallback=False, sleep=lambda s: None,
                       faults=FaultPlan.parse("nan@c6x*"), tracer=tracer) as pipe:
        handles = [pipe.submit(c) for c in _cases(8, rng)]
        pipe.drain()
    names = [ev["name"] for ev in tracer.events]
    assert names.count("serve.bisect") == pipe.report.bisections >= 3
    quar = [ev for ev in tracer.events if ev["name"] == "serve.quarantine"]
    assert len(quar) == 1
    assert quar[0]["args"]["case"] == 6
    assert quar[0]["args"]["classification"] == "corrupt"
    assert handles[6].error is not None
    assert all(h.result is not None for i, h in enumerate(handles) if i != 6)


def test_fetch_span_reports_effective_outcome_after_scan():
    clock = TickClock()
    tracer = Tracer(clock=clock)
    rng = np.random.default_rng(5)
    engine = _engine(batch_sizes=(1,))
    with ServePipeline(engine=engine, depth=1, window_ms=0.0, clock=clock, retries=0,
                       backoff_ms=0.0, fallback=False, sleep=lambda s: None,
                       faults=FaultPlan.parse("nan@c0x*"), tracer=tracer) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        pipe.drain()
    assert h.error is not None
    fetches = [ev for ev in tracer.events if ev["name"] == "serve.fetch"]
    assert fetches and all(ev["args"]["outcome"] == "corrupt" for ev in fetches)


def test_traced_ab_baseline_ignores_a_process_global_tracer():
    from nonlocalheatequation_torch.serve.server import serve_traced_ab

    installed = Tracer()
    prev = obs_trace.set_tracer(installed)
    try:
        rng = np.random.default_rng(13)
        serve_traced_ab(_engine(batch_sizes=(1,)), _cases(1, rng), depth=1, iters=1)
    finally:
        obs_trace.set_tracer(prev)
    assert all(not ev["name"].startswith("serve.") for ev in installed.events)
    pipe = ServePipeline(engine=_engine(batch_sizes=(1,)), depth=1,
                         tracer=obs_trace.TRACE_OFF)
    try:
        assert pipe._tracer is None
    finally:
        pipe.close()


def test_trace_write_degrades_exotic_span_args_to_str(tmp_path):
    from pathlib import Path

    tracer = Tracer(clock=TickClock())
    tracer.complete("serve.build", 0.001, 0.002, cat="serve", rate=np.float32(0.25),
                    where=Path("/x"))
    out = tmp_path / "t.json"
    assert tracer.write(str(out)) is True
    args = json.loads(out.read_text())["traceEvents"][0]["args"]
    assert args["rate"] == "0.25" and args["where"] == "/x"


def test_trace_write_is_atomic_concurrent_writers_never_tear(tmp_path):
    out = tmp_path / "host_trace.json"
    tracers = []
    for n in (3, 7):
        t = Tracer(clock=TickClock())
        for i in range(n):
            t.complete(f"serve.s{i}", 0.001 * (i + 1), 0.001 * (i + 2), cat="serve")
        tracers.append(t)
    threads = [threading.Thread(target=t.write, args=(str(out),)) for t in tracers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    doc = json.loads(out.read_text())  # valid, complete
    assert len(doc["traceEvents"]) in (3, 7)
    assert list(tmp_path.iterdir()) == [out]


def test_serve_traced_ab_floors_iters_at_one():
    from nonlocalheatequation_torch.serve.server import serve_traced_ab

    rng = np.random.default_rng(11)
    compile_s, plain, traced, tracer, rep = serve_traced_ab(
        _engine(batch_sizes=(1,)), _cases(1, rng), depth=1, iters=0)
    assert np.isfinite(plain) and np.isfinite(traced)
    assert tracer is not None and tracer.spans_total > 0
    assert rep is not None and rep.cases == 1


def test_serve_fence_ab_and_chaos_helpers():
    # the two other measurement helpers: the fenced and pipelined
    # schedules of the same cases over one engine (the program built once),
    # a chaos run whose first raise opens the breaker for good
    from nonlocalheatequation_torch.serve.server import serve_chaos, serve_fence_ab

    rng = np.random.default_rng(12)
    cases = _cases(4, rng)
    engine = _engine(batch_sizes=(1,))
    build_s, fenced, piped, rep = serve_fence_ab(engine, cases, depth=2, iters=1)
    assert min(build_s, fenced, piped) > 0 and rep.max_inflight == 2
    # the last schedule's report: the shared program cache built nothing
    assert engine.report.programs_built == 0 and engine.report.dispatches == 4
    wall, results, rep = serve_chaos(_engine(batch_sizes=(1,)), cases, depth=2,
                                     plan_spec="raise@1")
    want = _engine(batch_sizes=(1,)).run(cases)
    assert all(np.array_equal(a, b) for a, b in zip(results, want, strict=True))
    assert rep.fallback_chunks >= 1 and rep.breaker.state == "open"


# -- the acceptance chaos run ----------------------------------------------
def test_chaos_trace_and_expositions_agree_with_report_metrics(tmp_path):
    clock = StepClock()
    tracer = Tracer(clock=clock)
    rng = np.random.default_rng(7)
    cases = _cases(9, rng)
    engine = _engine(batch_sizes=(1,))
    with ServePipeline(engine=engine, depth=3, window_ms=0.0, clock=clock, retries=1,
                       backoff_ms=0.0, fetch_deadline_ms=100.0, breaker_threshold=1,
                       breaker_cooldown_ms=50.0, sleep=lambda s: None,
                       faults=FaultPlan.parse("raise@1,stall@3,nan@5,nan@c6x*"),
                       tracer=tracer) as pipe:
        for c in cases[:8]:
            pipe.submit(c)
        pipe.drain()
        clock.advance(0.1)  # breaker cooldown elapses
        pipe.submit(cases[8])  # the half-open probe
        pipe.drain()
    events = list(tracer.events)
    _check_schema(events)
    names = [ev["name"] for ev in events]
    assert names.count("serve.retry") == pipe.report.retries >= 1
    moves = [(ev["args"]["from"], ev["args"]["to"]) for ev in events
             if ev["name"] == "breaker.transition"]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    fallbacks = [ev for ev in events if ev["name"] == "serve.fallback"
                 and ev["args"]["outcome"] == "ok"]
    assert len(fallbacks) == pipe.report.fallback_chunks >= 1
    assert any(ev["name"] == "serve.quarantine" and ev["args"]["case"] == 6 for ev in events)
    out = tmp_path / "host_trace.json"
    assert tracer.write(str(out)) is True
    doc = json.load(open(out))
    assert doc["traceEvents"] and _check_schema(doc["traceEvents"]) is None

    m = pipe.metrics()
    res = m["resilience"]
    reg = pipe.registry
    snap = reg.snapshot()
    assert snap["/ensemble/cases"] == m["cases"]
    assert snap["/ensemble/dispatches"] == m["dispatches"]
    assert snap["/ensemble/buckets"] == m["buckets"]
    assert snap["/ensemble/programs-built"] == m["programs_built"]
    assert snap["/serve/retries"] == res["retries"]
    assert snap["/serve/bisections"] == res["bisections"]
    assert snap["/serve/fallback-chunks"] == res["fallback_chunks"]
    assert snap["/serve/faults"] == res["faults"]
    assert snap["/serve/quarantined"]["count"] == res["quarantined_total"]
    assert snap["/breaker/transitions"] == res["breaker"]["transition_count"] == len(moves)
    assert snap["/serve/request-latency-ms"]["count"] == m["requests_completed"]
    assert json.loads(reg.snapshot_json()) == json.loads(json.dumps(snap, default=float))
    assert "\n" not in reg.snapshot_json()
    prom = reg.prometheus()
    assert f"nlheat_serve_retries {res['retries']}" in prom
    assert f"nlheat_ensemble_cases {m['cases']}" in prom
    assert f"nlheat_breaker_transitions {res['breaker']['transition_count']}" in prom
    for label, count in res["faults"].items():
        assert f'nlheat_serve_faults{{key="{label}"}} {count}' in prom


# -- metrics registry -------------------------------------------------------
def test_registry_kinds_and_one_name_one_kind():
    reg = MetricsRegistry()
    c = reg.counter("/serve/retries")
    c.inc()
    c.inc(2)
    assert reg.counter("/serve/retries") is c and c.value == 3
    g = reg.gauge("/serve/depth")
    g.set(4)
    assert g.value == 4
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("/serve/retries")
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("/serve/depth")


def test_histogram_window_bounds_memory_count_stays_exact():
    reg = MetricsRegistry()
    h = reg.histogram("/serve/lat", window=8)
    for i in range(100):
        h.observe(float(i))
    assert len(h) == 8 and h.count == 100  # windowed + lifetime-exact
    assert h.total == sum(range(100))
    p = h.percentiles()
    assert p["max"] == 99.0 and p["p50"] >= 92.0  # the recent window
    t = reg.trail("/serve/log", window=4)
    for i in range(10):
        t.append({"i": i})
    assert [e["i"] for e in t] == [6, 7, 8, 9] and t.count == 10


def test_stable_copy_retries_racing_writer_then_defaults():
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise RuntimeError("deque mutated during iteration")
        return [1, 2]

    assert tmetrics._stable_copy(flaky, []) == [1, 2] and calls[0] == 3

    def hopeless():
        raise RuntimeError("deque mutated during iteration")

    assert tmetrics._stable_copy(hopeless, {"d": 1}) == {"d": 1}


def test_expositions_survive_a_racing_recorder_thread():
    reg = MetricsRegistry()
    h = reg.histogram("/serve/request-latency-ms", window=64)
    lab = reg.labeled("/serve/faults")
    stop = threading.Event()

    def record():
        i = 0
        while not stop.is_set():
            h.observe(float(i % 97))
            lab[f"k{i % 13}"] = lab.get(f"k{i % 13}", 0) + 1
            i += 1

    w = threading.Thread(target=record)
    w.start()
    try:
        for _ in range(300):
            prom = reg.prometheus()
            assert "nlheat_serve_request_latency_ms_count" in prom
            json.loads(reg.snapshot_json())
    finally:
        stop.set()
        w.join(timeout=30)
    assert not w.is_alive()


def test_prometheus_name_grammar_instance_becomes_label():
    reg = MetricsRegistry()
    reg.gauge("/device{3}/busy-rate").set(0.25)
    reg.counter("/serve{chunk}/retries").inc(2)
    reg.labeled("/serve/faults")["hang"] = 5
    prom = reg.prometheus()
    assert 'nlheat_device_busy_rate{device="3"} 0.25' in prom
    assert 'nlheat_serve_retries{serve="chunk"} 2' in prom
    assert 'nlheat_serve_faults{key="hang"} 5' in prom
    assert "# TYPE nlheat_device_busy_rate gauge" in prom
    assert "# TYPE nlheat_serve_retries counter" in prom


def _record(reg):
    """The same counter, gauge, histogram, trail and labeled updates."""
    reg.counter("/serve/retries").inc(3)
    reg.counter("/ensemble/cases").set(12)
    reg.gauge("/device{3}/busy-rate").set(0.25)
    reg.gauge("/serve/depth").set(2)
    reg.gauge("/solve{2d}/elapsed-s").set(1.234567)
    reg.gauge("/flag").set(True)
    h = reg.histogram("/serve/request-latency-ms", window=16)
    for v in (0.5, 1.25, 3.0, 7.75, 100.0, 2e-7, 123456.789):
        h.observe(v)
    t = reg.trail("/serve/chunk-log", window=4)
    for i in range(6):
        t.append({"i": i})
    lab = reg.labeled("/serve/faults")
    lab["hang"] = 2
    lab["error"] = 1
    reg.labeled("/serve/closes")  # empty: its TYPE line alone
    reg.labeled('/odd{a"b}/x')['q"\\'] = 4


def test_expositions_byte_equal_the_jax_registry():
    ours, theirs = MetricsRegistry(), jmetrics.MetricsRegistry()
    _record(ours)
    _record(theirs)
    assert ours.prometheus() == theirs.prometheus()
    assert ours.snapshot_json() == theirs.snapshot_json()
    assert ours.names() == theirs.names()
    assert tmetrics._prom_name("/device{3}/busy-rate") == \
        jmetrics._prom_name("/device{3}/busy-rate")
    # the absorbed form and the prefix drop
    snap = ours.snapshot()
    a, b = MetricsRegistry(), jmetrics.MetricsRegistry()
    tmetrics.absorb_snapshot(a, "/replica{3}", snap)
    jmetrics.absorb_snapshot(b, "/replica{3}", snap)
    assert a.prometheus() == b.prometheus()
    assert a.drop_prefix("/replica{3}/serve") == b.drop_prefix("/replica{3}/serve") > 0
    assert a.snapshot_json() == b.snapshot_json()
    assert texport.merged_prometheus([ours, a]) == jexport.merged_prometheus([theirs, b])
    assert texport.merged_snapshot_json([ours, a]) == jexport.merged_snapshot_json([theirs, b])


def test_serve_report_expositions_byte_equal_the_jax_report():
    # the same served stream through both pipelines on injected clocks: the
    # registries hold the same names, and every counter and labeled count
    # the same value
    rng = np.random.default_rng(30)
    cases = _cases(5, rng)
    jcases = [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                                test=False, u0=c.u0) for c in cases]
    with ServePipeline(engine=_engine(), depth=2, window_ms=0.0, clock=StepClock(),
                       faults=FaultPlan.parse("nan@c3x*"), retries=0) as pipe:
        pipe.serve_cases(cases)
    with jserver.ServePipeline(depth=2, window_ms=0.0, clock=StepClock(), retries=0,
                               faults=jfaults.FaultPlan.parse("nan@c3x*")) as jpipe:
        jpipe.serve_cases(jcases)
    ours, theirs = pipe.registry, jpipe.registry
    assert ours.names() == theirs.names()

    def counts(reg):
        return [ln for ln in reg.prometheus().splitlines()
                if "latency" not in ln and "queue_wait" not in ln]

    assert counts(ours) == counts(theirs)


def test_report_and_registry_share_one_storage():
    from nonlocalheatequation_torch.serve.server import LOG_CAP, ServeReport

    r = ServeReport(depth=2)
    r.retries += 3
    r.faults["hang"] = r.faults.get("hang", 0) + 1
    assert r.registry.get("/serve/retries").value == 3
    assert r.registry.get("/serve/faults")["hang"] == 1
    r.registry.get("/serve/retries").inc()  # the other direction
    assert r.retries == 4
    assert ServeReport().retries == 0  # a private registry each
    for w in (r.chunk_log.entries, r.occupancy_samples.entries, r.quarantined.entries,
              r.request_latency_ms.samples, r.queue_wait_ms.samples):
        assert w.maxlen == LOG_CAP


def test_publish_busy_rates_counts_windows_vs_actual_rebalances():
    from nonlocalheatequation_torch.parallel.load_balance import publish_busy_rates

    reg = MetricsRegistry()
    publish_busy_rates([0.2, 0.8], moved=0, registry=reg)  # ran, no moves
    publish_busy_rates([0.5, 0.5], moved=3, registry=reg)
    snap = reg.snapshot()
    assert snap["/balance/windows"] == 2
    assert snap["/balance/rebalances"] == 1  # only the window that moved
    assert snap["/balance/tiles-moved"] == 3
    assert snap["/device{0}/busy-rate"] == 0.5  # latest window's gauge


# -- trace merge and context ------------------------------------------------
def _two_docs(mod):
    a = mod.Tracer(clock=TickClock(), pid=11, label="replica 0", replica=0,
                   clock_sync={"monotonic": 100.0, "wall": 5000.0})
    b = mod.Tracer(clock=TickClock(), pid=12, label="replica 1", replica=1,
                   clock_sync={"monotonic": 50.0, "wall": 5000.5})
    ctx = mod.TraceContext("abcd", "s1", 4)
    prev = mod.set_context(ctx)
    try:
        a.complete("serve.build", 100.001, 100.003, cat="serve", chunk=0)
        a.instant("serve.dispatch", ts=100.004, cat="serve", chunk=0)
        a.flow("request", "start", ctx.trace_id, ts=100.0005)
        b.counter("serve.inflight", ts=50.6, inflight=1)
        b.flow("request", "finish", ctx.trace_id, ts=50.7, cat="serve", req=4)
    finally:
        mod.set_context(prev)
    return [a.chrome_trace(), b.chrome_trace(), {"traceEvents": [
        {"name": "x", "ph": "i", "s": "t", "ts": 3.0, "pid": 9, "tid": 0}]}]


def test_merge_chrome_traces_equals_the_jax_merge():
    ours = obs_trace.merge_chrome_traces(_two_docs(obs_trace))
    theirs = jtrace.merge_chrome_traces(_two_docs(jtrace))
    assert ours == theirs
    assert [e["pid"] for e in ours["traceEvents"] if e["ph"] == "M"] == [0, 1]


def test_trace_context_wire_and_header_forms_match_jax():
    for ctx in (obs_trace.TraceContext("ab12", "sp", 7), obs_trace.TraceContext("ab12"),
                obs_trace.TraceContext("ab12", None, 3)):
        jctx = jtrace.TraceContext(ctx.trace_id, ctx.span_id, ctx.request)
        assert ctx.to_wire() == jctx.to_wire() and ctx.to_header() == jctx.to_header()
        back = obs_trace.TraceContext.from_header(ctx.to_header())
        assert back.to_wire() == jtrace.TraceContext.from_header(jctx.to_header()).to_wire()
        assert obs_trace.TraceContext.from_wire(ctx.to_wire()).to_wire() == ctx.to_wire()
    assert obs_trace.TraceContext.from_wire(None) is None
    assert obs_trace.TraceContext.from_header("") is None
    assert obs_trace.current_context() is None
    assert len(obs_trace.TraceContext.mint().trace_id) == 16
    child = obs_trace.TraceContext("t", "a", 1).child("b")
    assert child.to_wire() == ("t", "b", 1)


def test_write_chrome_trace_never_raises(tmp_path):
    doc = obs_trace.merge_chrome_traces(_two_docs(obs_trace))
    assert obs_trace.write_chrome_trace(doc, str(tmp_path / "m.json")) is True
    assert json.loads((tmp_path / "m.json").read_text()) == json.loads(json.dumps(doc))
    assert obs_trace.write_chrome_trace(doc, str(tmp_path)) is False


# -- exporters --------------------------------------------------------------
def test_scrape_endpoint_serves_both_expositions():
    reg = MetricsRegistry()
    reg.counter("/serve/retries").inc(3)
    srv = serve_metrics(0, reg)  # port 0: pick a free one
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=30).read().decode()
        assert "nlheat_serve_retries 3" in text
        js = json.loads(urllib.request.urlopen(f"{base}/metrics.json", timeout=30).read())
        assert js["/serve/retries"] == 3
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/other", timeout=30)
    finally:
        srv.close()


def test_scrape_endpoint_follows_a_live_registry_binding():
    holder = [MetricsRegistry()]
    srv = serve_metrics(0, lambda: holder[0])
    try:
        base = f"http://127.0.0.1:{srv.port}"
        holder[0].gauge("/serve/depth").set(1)
        js = json.loads(urllib.request.urlopen(f"{base}/metrics.json", timeout=30).read())
        assert js == {"/serve/depth": 1}
        holder[0] = MetricsRegistry()  # a new pipeline's registry
        holder[0].gauge("/serve/depth").set(8)
        js = json.loads(urllib.request.urlopen(f"{base}/metrics.json", timeout=30).read())
        assert js == {"/serve/depth": 8}
    finally:
        srv.close()


def test_event_log_streams_serve_events_as_jsonl(tmp_path, monkeypatch):
    path = tmp_path / "events.jsonl"
    monkeypatch.setenv("NLHEAT_EVENT_LOG", str(path))
    clock = TickClock()
    rng = np.random.default_rng(11)
    with ServePipeline(engine=_engine(batch_sizes=(1,)), depth=1, window_ms=0.0,
                       clock=clock, retries=1, backoff_ms=0.0, sleep=lambda s: None,
                       faults=FaultPlan.parse("raise@0")) as pipe:
        for c in _cases(2, rng):
            pipe.submit(c)
        pipe.drain()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    kinds = [ln["event"] for ln in lines]
    assert kinds.count("retry") == pipe.report.retries == 1
    assert kinds.count("chunk") == 2  # one record per retired chunk
    assert lines[0]["classification"] == "error"
    # the JAX reader reads the port's log unchanged, and the merge agrees
    assert jexport.read_jsonl(str(path)) == texport.read_jsonl(str(path)) == lines
    assert texport.merge_event_streams([lines]) == jexport.merge_event_streams([lines])


def test_event_log_unopenable_path_is_loud_but_not_fatal(tmp_path, capsys):
    log = EventLog.from_env({"NLHEAT_EVENT_LOG": str(tmp_path / "no" / "dir" / "x.jsonl")})
    assert log is None
    assert "cannot be opened" in capsys.readouterr().err
    assert EventLog.from_env({}) is None  # unset: the zero-cost path


def test_event_log_emit_is_thread_safe_one_json_per_line(tmp_path):
    path = tmp_path / "e.jsonl"
    log = EventLog(str(path))
    threads = [threading.Thread(target=lambda i=i: [log.emit(event="t", thread=i, n=j)
                                                    for j in range(50)]) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    log.close()
    lines = path.read_text().splitlines()
    assert len(lines) == 200
    assert all(json.loads(ln)["event"] == "t" for ln in lines)
