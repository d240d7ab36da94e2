"""The port's serving pipeline (nonlocalheatequation_torch/serve/server.py) on
the CPU, mirroring tests/test_serve.py and held against the JAX package.

What these tests pin, in float64:

* the microbatch window closes by SIZE (the engine's top batch size) and by
  TIME (window_ms, an injected clock), a per-case deadline forces its
  bucket's chunk out early, ``drain()`` flushes open, ready and in-flight
  work, and the in-flight cap D is reached and never exceeded;
* the fence discipline: >= 2 chunks in flight with ZERO fences between
  their dispatches (spies on the module-level fence_scalar and the engine's
  dispatch stage), one fence per retire;
* served results are BITWISE the port's offline ``EnsembleEngine.run()``
  on the same cases (the CPU plain versions), with the same padding,
  buckets and dispatches;
* the same seeded cases through the JAX ``ServePipeline`` and the port's
  give states within 1e-12 at depths 1 and 3, the same chunk, forced-close
  and dispatch counts.

The JAX suite's donation test has no counterpart: the port's programs never
write their input, so there is no donation to refuse.
"""

import json

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.serve import server as server_mod
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import server as jserver

torch.set_num_threads(1)

NX, NY, EPS, NSTEPS = 16, 16, 2, 2
MIXED = [(1.0, 1e-4, 0.02), (0.5, 2e-4, 0.02), (0.2, 1e-4, 0.01)]
CPU = "cpu"


def _cases(n, rng, shape=(NX, NY), nt=NSTEPS, cls=EnsembleCase):
    out = []
    for i in range(n):
        k, dt, dh = MIXED[i % len(MIXED)]
        out.append(cls(shape=shape, nt=nt, eps=EPS, k=k, dt=dt, dh=dh, test=False,
                       u0=rng.normal(size=shape)))
    return out


def _jax_twins(cases):
    """The JAX package's EnsembleCase of each port case (the same arrays)."""
    return [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                              test=c.test, u0=c.u0) for c in cases]


def _engine(**kw):
    return EnsembleEngine(device=CPU, **kw)


def _pipe(**kw):
    """A CPU pipeline: the port's entry points default to the card."""
    if "engine" not in kw:
        kw["device"] = CPU
    return ServePipeline(**kw)


class FakeClock:
    """Injected scheduler clock: window/deadline tests advance time
    explicitly instead of racing host load."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _spies(pipe, monkeypatch):
    """Event log of (kind,) for every dispatch and every fence."""
    events = []
    real_fence = server_mod.fence_scalar
    monkeypatch.setattr(server_mod, "fence_scalar",
                        lambda x: (events.append("fence"), real_fence(x))[1])
    real_dispatch = pipe.engine.dispatch_chunk
    pipe.engine.dispatch_chunk = (
        lambda multi, U0: (events.append("dispatch"), real_dispatch(multi, U0))[1])
    return events


def test_size_triggered_close_and_single_fence(monkeypatch):
    rng = np.random.default_rng(0)
    with _pipe(depth=1, window_ms=10_000.0) as pipe:
        events = _spies(pipe, monkeypatch)
        handles = [pipe.submit(c) for c in _cases(8, rng)]
        # the 8th submit hit the size trigger: closed + dispatched, but NOT
        # fenced — no result is due yet
        assert pipe.report.dispatches == 1
        assert pipe.report.forced_closes == {"size": 1}
        assert events == ["dispatch"]
        assert all(h.result is None for h in handles)
        pipe.drain()
        assert events == ["dispatch", "fence"]
        assert all(h.result is not None for h in handles)


def test_time_triggered_close_with_injected_clock():
    rng = np.random.default_rng(1)
    clock = FakeClock()
    with _pipe(depth=1, window_ms=10.0, clock=clock) as pipe:
        for c in _cases(3, rng):
            pipe.submit(c)
        assert pipe.report.dispatches == 0  # 3 < size trigger, window open
        clock.advance(0.005)
        pipe.pump()
        assert pipe.report.dispatches == 0  # still inside the window
        clock.advance(0.006)  # past 10 ms
        pipe.pump()
        assert pipe.report.dispatches == 1
        assert pipe.report.forced_closes == {"window": 1}
        assert pipe.report.padded_cases == 1  # 3 real lanes pad up to 4
        pipe.drain()
    assert pipe.report.cases == 3


def test_deadline_forces_partial_chunk():
    rng = np.random.default_rng(2)
    clock = FakeClock()
    with _pipe(depth=1, window_ms=10_000.0, clock=clock) as pipe:
        a, b = _cases(2, rng)
        pipe.submit(a)
        pipe.submit(b, deadline_ms=5.0)  # far inside the huge window
        assert pipe.report.dispatches == 0
        clock.advance(0.006)
        pipe.pump()
        # the aging case forced the whole bucket's chunk out early
        assert pipe.report.dispatches == 1
        assert pipe.report.forced_closes == {"deadline": 1}
        pipe.drain()
        assert pipe.report.chunk_log[0]["cases"] == 2
        assert pipe.report.chunk_log[0]["closed_by"] == "deadline"


def test_drain_flushes_open_ready_and_inflight():
    rng = np.random.default_rng(3)
    cases = _cases(3, rng) + _cases(2, rng, shape=(20, 16))
    with _pipe(depth=2, window_ms=10_000.0) as pipe:
        handles = [pipe.submit(c) for c in cases]
        assert pipe.report.dispatches == 0  # everything still accumulating
        pipe.drain()
        assert all(h.result is not None for h in handles)
        assert pipe.report.buckets == 2
        assert pipe.report.dispatches == 2
        assert pipe.report.forced_closes == {"drain": 2}
        assert len(pipe._inflight) == 0 and not pipe._ready


def test_inflight_cap_respected_and_reached():
    rng = np.random.default_rng(4)
    # batch size 1: every case is its own chunk -> 6 dispatches compete for
    # 2 in-flight slots
    with _pipe(depth=2, window_ms=0.0, batch_sizes=(1,)) as pipe:
        pipe.serve_cases(_cases(6, rng))
        occ = [n for _t, n in pipe.report.occupancy_samples]
        assert max(occ) == 2  # cap reached (real overlap)...
        assert all(n <= 2 for n in occ)  # ...and never exceeded
        assert pipe.report.dispatches == 6
    m = pipe.metrics()
    assert m["occupancy"]["max"] == 2


def test_no_fence_between_dispatches_and_bit_identity(monkeypatch):
    # with D=3 and single-case chunks, the pipeline must put >= 2 chunks in
    # flight with ZERO fences between their dispatches, then retire with
    # exactly one fence per chunk — and the served results must be bitwise
    # the offline engine's
    rng = np.random.default_rng(5)
    cases = _cases(5, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    with _pipe(depth=3, window_ms=0.0, batch_sizes=(1,)) as pipe:
        events = _spies(pipe, monkeypatch)
        served = pipe.serve_cases(cases)
    # pipe fill: the first D dispatches are back to back, no fence between
    assert events[:3] == ["dispatch"] * 3
    assert events.count("dispatch") == 5
    assert events.count("fence") == 5  # one per retire, none elsewhere
    assert max(n for _t, n in pipe.report.occupancy_samples) >= 2
    for got, want in zip(served, offline, strict=True):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("method", ["auto", "cuda"])
def test_bit_identity_mixed_buckets_vs_offline(method):
    # mixed physics AND mixed shapes, chunk padding engaged: the served set
    # reproduces run() bit for bit with the same padding count; ``cuda``
    # runs the batched kernels' plain versions (B6 on the card)
    rng = np.random.default_rng(6)
    cases = _cases(6, rng) + _cases(3, rng, shape=(20, 16))
    offline_engine = _engine(method=method)
    offline = offline_engine.run(cases)
    with _pipe(depth=3, window_ms=10_000.0, method=method) as pipe:
        served = pipe.serve_cases(cases)
    for got, want in zip(served, offline, strict=True):
        assert np.array_equal(got, want)
    assert pipe.report.padded_cases == offline_engine.report.padded_cases
    assert pipe.report.buckets == offline_engine.report.buckets
    assert pipe.report.dispatches == offline_engine.report.dispatches


def test_wait_forces_one_request():
    rng = np.random.default_rng(7)
    with _pipe(depth=2, window_ms=10_000.0) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        assert h.result is None
        out = h.wait()  # implicit immediate deadline for its chunk
        assert out is not None and out.shape == (NX, NY)
        assert pipe.report.forced_closes == {"wait": 1}
        assert h.latency_s is not None and h.queue_wait_s is not None


def test_priority_orders_ready_chunks():
    rng = np.random.default_rng(8)
    clock = FakeClock()
    with _pipe(depth=1, window_ms=5.0, clock=clock) as pipe:
        pipe.submit(_cases(1, rng)[0], priority=0)
        for c in _cases(2, rng, shape=(20, 16)):
            pipe.submit(c, priority=5)
        clock.advance(0.01)
        pipe.pump()  # both buckets close; the prio-5 chunk dispatches first
        pipe.drain()
        assert [c["cases"] for c in pipe.report.chunk_log] == [2, 1]


def test_metrics_json_one_call_dump():
    rng = np.random.default_rng(9)
    with _pipe(depth=2, window_ms=0.0, batch_sizes=(1, 2)) as pipe:
        pipe.serve_cases(_cases(4, rng))
        line = pipe.metrics_json()
    m = json.loads(line)
    for key in ("cases", "chunks", "dispatches", "depth", "window_ms",
                "request_latency_ms", "queue_wait_ms", "occupancy",
                "forced_closes", "chunk_log", "build_ms_total",
                "device_ms_total", "fetch_ms_total", "store", "resilience"):
        assert key in m, key
    assert m["cases"] == 4 and m["depth"] == 2
    assert {"p50", "p90", "p99", "mean", "max"} <= set(m["request_latency_ms"])
    for c in m["chunk_log"]:
        assert {"build_ms", "device_ms", "fetch_ms", "closed_by"} <= set(c)
    # the program-store block keeps the JAX keys, its store counters zero
    store = m["store"]
    assert set(store) == {"hits", "misses", "saves", "refusals", "load_ms", "serialize_ms",
                          "resident_programs", "evictions"}
    assert (store["hits"], store["misses"], store["saves"], store["refusals"]) == (0, 0, 0, {})


def test_pipeline_validation_refusals():
    with pytest.raises(ValueError, match="depth"):
        _pipe(depth=0)
    with pytest.raises(ValueError, match="window_size"):
        _pipe(window_size=16)  # above the top batch size
    with pytest.raises(ValueError, match="window_ms"):
        _pipe(window_ms=-1.0)
    with pytest.raises(ValueError, match="not both"):
        ServePipeline(_engine(), method="sat")
    # slo= builds the promise ledger (obs/slo.py); its summary joins metrics()
    with _pipe(slo=True) as audited:
        assert audited.metrics()["slo"]["promised"] == 0
    with _pipe(slo=False, depth=1) as plain:
        assert "slo" not in plain.metrics()
    pipe = _pipe(depth=1)
    pipe.close()
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(EnsembleCase(shape=(NX, NY), nt=1, eps=EPS, k=1.0, dt=1e-4, dh=0.02,
                                 test=False, u0=np.zeros((NX, NY))))


def test_picked_engine_keys_a_chunk_of_its_own():
    # an engine= pick (the (stepper, stages, method, precision) key) is
    # served by the pool's sibling in chunks of its own; the default key is
    # the pipeline's engine; sticky_key is inert
    rng = np.random.default_rng(10)
    cases = _cases(4, rng)
    with _pipe(depth=2, window_ms=10_000.0) as pipe:
        key = pipe.engine.engine_key()
        a = [pipe.submit(c, engine=key, sticky_key="s") for c in cases[:2]]
        b = [pipe.submit(c, engine=("euler", 0, "shift", "f32")) for c in cases[2:]]
        pipe.drain()
    assert pipe.report.buckets == 2 and pipe.report.dispatches == 2
    want_a = _engine().run(cases[:2])
    want_b = _engine(method="shift").run(cases[2:])
    for h, w in zip(a + b, want_a + want_b, strict=True):
        assert np.array_equal(h.result, w)


@pytest.mark.parametrize("depth", [1, 3])
def test_served_states_match_the_jax_pipeline(depth):
    # the same seeded cases, mixed physics and shapes, padding engaged,
    # through both pipelines: states within 1e-12 (f64), the same chunks,
    # forced closes, dispatches and padding
    rng = np.random.default_rng(20 + depth)
    cases = _cases(7, rng) + _cases(3, rng, shape=(20, 16))
    clock, jclock = FakeClock(), FakeClock()
    with _pipe(depth=depth, window_ms=5.0, clock=clock) as pipe:
        ours = [pipe.submit(c) for c in cases[:5]]
        clock.advance(0.01)
        pipe.pump()
        ours += [pipe.submit(c) for c in cases[5:]]
        pipe.drain()
    with jserver.ServePipeline(depth=depth, window_ms=5.0, clock=jclock) as jpipe:
        jcases = _jax_twins(cases)
        theirs = [jpipe.submit(c) for c in jcases[:5]]
        jclock.advance(0.01)
        jpipe.pump()
        theirs += [jpipe.submit(c) for c in jcases[5:]]
        jpipe.drain()
    for h, j in zip(ours, theirs, strict=True):
        got, want = h.result, np.asarray(j.result)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-12 * max(1.0, float(np.abs(want).max()))
    m, jm = pipe.metrics(), jpipe.metrics()
    for key in ("cases", "buckets", "chunks", "dispatches", "padded_cases", "forced_closes"):
        assert m[key] == jm[key], key
    assert [c["cases"] for c in m["chunk_log"]] == [c["cases"] for c in jm["chunk_log"]]
