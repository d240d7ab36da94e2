"""Chaos suite of the port's serving pipeline (serve/server.py supervision,
serve/resilience.py, utils/faults.py), on the CPU in float64 with no card,
mirroring tests/test_serve_faults.py and held against the JAX package.

Every fault is injected deterministically by a plan (utils/faults.py
grammar), every breaker transition is driven by an injected clock, and every
assertion reads ``ServeReport.metrics()``.  On the CPU the engine's chunks
and the CPU fallback's run the same plain composition, so fallback-served
lanes are bitwise the offline engine's here (on the card they are close,
not bitwise).  The same plans through the JAX ``ServePipeline`` give the
same classifications, quarantined seqs and breaker transitions.

The JAX suite's donation-pin test has no counterpart: the port has no
donation to pin.
"""

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.resilience import (
    TRANSITION_CAP,
    CircuitBreaker,
    CpuFallback,
    ServeError,
)
from nonlocalheatequation_torch.serve import server as server_mod
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils.faults import FaultPlan
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import server as jserver
from nonlocalheatequation_tpu.utils import faults as jfaults

torch.set_num_threads(1)

NX, NY, EPS, NSTEPS = 16, 16, 2, 2
MIXED = [(1.0, 1e-4, 0.02), (0.5, 2e-4, 0.02), (0.2, 1e-4, 0.01)]
CPU = "cpu"


def _cases(n, rng, shape=(NX, NY), nt=NSTEPS):
    out = []
    for i in range(n):
        k, dt, dh = MIXED[i % len(MIXED)]
        out.append(EnsembleCase(shape=shape, nt=nt, eps=EPS, k=k, dt=dt, dh=dh, test=False,
                                u0=rng.normal(size=shape)))
    return out


def _jax_twins(cases):
    return [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                              test=c.test, u0=c.u0) for c in cases]


def _engine(**kw):
    return EnsembleEngine(device=CPU, **kw)


def _pipe(**kw):
    if "engine" not in kw:
        kw["device"] = CPU
    return ServePipeline(**kw)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- plan grammar ----------------------------------------------------------
def test_plan_parses_targets_counts_and_log():
    plan = FaultPlan.parse("raise@1,stall@3x2,nan@c5x*")
    kinds = [e.kind for e in plan.entries]
    assert kinds == ["raise", "stall", "nan"]
    assert plan.entries[0].attempt == 1 and plan.entries[0].left == 1
    assert plan.entries[1].attempt == 3 and plan.entries[1].left == 2
    assert plan.entries[2].case == 5 and plan.entries[2].left == float("inf")
    fired = plan.draw([0])  # attempt 0: nothing matches
    assert not fired.any()
    fired = plan.draw([5])  # attempt 1: raise@1 AND nan@c5 both match
    assert fired.raise_ is not None and fired.nan is not None
    assert [f["kind"] for f in plan.fired_log] == ["raise", "nan"]
    # a fresh plan fires the same entries on the same draws as the JAX one
    plan = FaultPlan.parse("raise@1,stall@3x2,nan@c5x*")
    jplan = jfaults.FaultPlan.parse("raise@1,stall@3x2,nan@c5x*")
    for seqs in ([0], [5], [1], [5], [2]):
        jplan.draw(seqs)
        plan.draw(seqs)
    assert plan.fired_log == jplan.fired_log
    assert [e.describe() for e in plan.entries] == [e.describe() for e in jplan.entries]


@pytest.mark.parametrize("bad", [
    "raise", "boom@1", "nan@c", "stall@1x0", "raise@", "", "nan@cx*",
])
def test_plan_refuses_bad_specs_loudly(bad):
    with pytest.raises(ValueError, match="fault.plan|entries") as ours:
        FaultPlan.parse(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.FaultPlan.parse(bad)
    assert str(ours.value) == str(theirs.value)


def test_attempt_targeted_count_fires_on_consecutive_attempts():
    # the xN count on an attempt-targeted entry is a RANGE: raise@1x2 fires
    # at attempts 1 AND 2 — with a depth-1 schedule that is an attempt and
    # its immediate retry
    plan = FaultPlan.parse("raise@1x2")
    assert [plan.draw([0]).raise_ is not None for _ in range(4)] == \
        [False, True, True, False]
    rng = np.random.default_rng(11)
    cases = _cases(2, rng)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), retries=2, backoff_ms=0.0,
               fallback=False, faults=FaultPlan.parse("raise@1x2")) as pipe:
        handles = [pipe.submit(c) for c in cases]
        pipe.drain()
    # case 1's first attempt (attempt 1) and its retry (attempt 2) both
    # raise; the second retry serves — two retries, two errors, no poison
    assert all(h.result is not None for h in handles)
    m = pipe.metrics()["resilience"]
    assert m["faults"] == {"error": 2}
    assert m["retries"] == 2 and m["quarantined"] == []
    # the request still carries its queue wait though its chunk's FIRST
    # attempt died in the dispatch stage
    assert all(h.queue_wait_s is not None for h in handles)


def test_env_plan_reaches_default_pipeline(monkeypatch):
    monkeypatch.setenv("NLHEAT_FAULT_PLAN", "raise@0")
    rng = np.random.default_rng(0)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), backoff_ms=0.0) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        out = h.wait()  # injected failure, retried, served
    assert out is not None
    assert pipe.metrics()["resilience"]["faults"] == {"error": 1}


# -- table-driven classification -------------------------------------------
#    (spec pattern, fetch deadline, expected classification)
FAULT_TABLE = [
    ("raise@{t}", None, "error"),
    ("stall@{t}", 60.0, "hang"),
    ("nan@{t}", None, "corrupt"),
]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("spec,deadline,cls", FAULT_TABLE)
def test_transient_fault_classified_retried_and_served(depth, spec, deadline, cls):
    # one fault firing once at the first dispatch: classified, retried
    # exactly once, and the request still serves bitwise
    rng = np.random.default_rng(1)
    cases = _cases(1, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    engine = _engine(batch_sizes=(1,))
    with ServePipeline(engine=engine, depth=depth, window_ms=0.0, retries=2,
                       backoff_ms=0.0, fallback=False, fetch_deadline_ms=deadline,
                       faults=FaultPlan.parse(spec.format(t=0))) as pipe:
        h = pipe.submit(cases[0])
        out = h.wait()
    m = pipe.metrics()["resilience"]
    assert m["faults"] == {cls: 1}
    assert m["retries"] == 1
    assert m["quarantined"] == []
    assert np.array_equal(out, offline[0])


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("spec,deadline,cls", FAULT_TABLE)
def test_persistent_fault_exhausts_retries_and_quarantines(depth, spec, deadline, cls):
    # the same fault made persistent and case-targeted: the retry budget (2)
    # is spent, the single-case chunk quarantines, wait() raises the typed
    # error, and the other cases in the stream are unaffected
    rng = np.random.default_rng(2)
    cases = _cases(4, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    engine = _engine(batch_sizes=(1,))
    with ServePipeline(engine=engine, depth=depth, window_ms=0.0, retries=2,
                       backoff_ms=0.0, fallback=False, fetch_deadline_ms=deadline,
                       faults=FaultPlan.parse(spec.format(t="c2x*"))) as pipe:
        handles = [pipe.submit(c) for c in cases]
        pipe.drain()
        with pytest.raises(ServeError) as ei:
            handles[2].wait()
    err = ei.value
    assert err.classification == cls
    assert err.case_seq == 2 and err.attempts == 3
    m = pipe.metrics()["resilience"]
    assert m["faults"] == {cls: 3}
    assert m["retries"] == 2
    assert m["quarantined"] == [
        {"case": 2, "classification": cls, "attempts": 3, "chunk": err.chunk_id}]
    for i in (0, 1, 3):
        assert np.array_equal(handles[i].result, offline[i])


def test_hang_classification_releases_only_its_own_stall():
    # two chunks in flight, both stall-armed: chunk A's transient hang must
    # leave chunk B's persistent stall armed — B still quarantines, A still
    # serves (outcomes never depend on interleaving)
    rng = np.random.default_rng(10)
    cases = _cases(2, rng)
    with _pipe(depth=2, window_ms=0.0, batch_sizes=(1,), retries=1, backoff_ms=0.0,
               fallback=False, fetch_deadline_ms=60.0,
               faults=FaultPlan.parse("stall@0,stall@c1x*")) as pipe:
        ha = pipe.submit(cases[0])
        hb = pipe.submit(cases[1])
        pipe.drain()
    assert ha.result is not None and ha.error is None
    assert hb.error is not None
    assert hb.error.classification == "hang"
    m = pipe.metrics()["resilience"]
    assert [q["case"] for q in m["quarantined"]] == [1]


def test_exponential_backoff_recorded_and_slept():
    slept = []
    rng = np.random.default_rng(3)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), retries=2, backoff_ms=100.0,
               fallback=False, faults=FaultPlan.parse("raise@c0x*"),
               sleep=slept.append) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        pipe.drain()
    assert h.error is not None
    assert slept == [0.1, 0.2]  # backoff_ms * 2^(attempt-1); exhaustion sleeps nothing
    assert pipe.metrics()["resilience"]["backoff_ms_total"] == 300.0


def test_corrupt_results_never_open_the_breaker():
    # a persistent NaN is DATA-shaped: it quarantines through the normal
    # retry/bisect path WITHOUT opening the breaker
    rng = np.random.default_rng(12)
    cases = _cases(3, rng)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), retries=1, backoff_ms=0.0,
               breaker_threshold=1, breaker_cooldown_ms=1e6,
               faults=FaultPlan.parse("nan@c1x*")) as pipe:
        handles = [pipe.submit(c) for c in cases]
        pipe.drain()
    m = pipe.metrics()["resilience"]
    assert [q["case"] for q in m["quarantined"]] == [1]
    assert m["breaker"]["state"] == "closed"
    assert m["breaker"]["transitions"] == []
    assert m["fallback_chunks"] == 0
    assert handles[0].result is not None and handles[2].result is not None


def test_corrupt_half_open_probe_clears_and_recloses_the_breaker():
    # a half-open probe whose fetch comes back corrupt CLEARS the probe and
    # re-closes the breaker (the device path executed and delivered)
    clock = FakeClock()
    rng = np.random.default_rng(13)
    cases = _cases(4, rng)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), clock=clock, retries=1,
               backoff_ms=0.0, breaker_threshold=1, breaker_cooldown_ms=50.0,
               faults=FaultPlan.parse("raise@0,nan@c2x*")) as pipe:
        handles = [pipe.submit(c) for c in cases[:2]]
        pipe.drain()  # case0: raise -> open; retry + case1 via fallback
        assert pipe.metrics()["resilience"]["breaker"]["state"] == "open"
        clock.advance(0.1)  # cooldown elapses
        handles.append(pipe.submit(cases[2]))  # the probe — corrupt!
        handles.append(pipe.submit(cases[3]))
        pipe.drain()
    m = pipe.metrics()["resilience"]
    moves = [(t["from"], t["to"]) for t in m["breaker"]["transitions"]]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    assert [q["case"] for q in m["quarantined"]] == [2]
    for i in (0, 1, 3):
        assert handles[i].result is not None, i


def test_nan_policy_serve_keeps_diverged_results():
    rng = np.random.default_rng(4)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), nan_policy="serve",
               faults=FaultPlan.parse("nan@0")) as pipe:
        out = pipe.submit(_cases(1, rng)[0]).wait()
    assert not np.all(np.isfinite(out))
    m = pipe.metrics()["resilience"]
    assert m["faults"] == {} and m["retries"] == 0


# -- bisection quarantine ---------------------------------------------------
def test_bisection_isolates_poison_case_mates_served_bit_identical():
    # one 8-case chunk with a persistent NaN on case 5: bisected 8 -> 4 -> 2
    # -> 1 (3 bisections), exactly case 5 quarantines, the 7 mates match the
    # offline engine bit for bit
    rng = np.random.default_rng(5)
    cases = _cases(8, rng)
    offline = _engine(batch_sizes=(8,)).run(cases)
    engine = _engine(batch_sizes=(8,))
    with ServePipeline(engine=engine, depth=1, window_ms=10_000.0, retries=1,
                       backoff_ms=0.0, fallback=False,
                       faults=FaultPlan.parse("nan@c5x*")) as pipe:
        handles = [pipe.submit(c) for c in cases]
        pipe.drain()
    m = pipe.metrics()["resilience"]
    assert m["bisections"] == 3
    assert [q["case"] for q in m["quarantined"]] == [5]
    assert m["quarantined"][0]["classification"] == "corrupt"
    with pytest.raises(ServeError, match="case 5 quarantined"):
        handles[5].wait()
    for i in range(8):
        if i == 5:
            continue
        assert np.array_equal(handles[i].result, offline[i]), i
    assert m["retries"] == 4
    assert m["faults"] == {"corrupt": 8}
    assert pipe.metrics()["forced_closes"]["bisect"] == 6


# -- circuit breaker --------------------------------------------------------
def test_breaker_unit_lifecycle_with_injected_clock():
    clock = FakeClock()
    br = CircuitBreaker(threshold=2, cooldown_ms=100.0, clock=clock)
    assert br.route() == "device"
    br.record_failure()
    assert br.state == "closed" and br.route() == "device"
    br.record_failure()  # 2 consecutive -> open
    assert br.state == "open" and br.route() == "fallback"
    clock.advance(0.05)
    assert br.route() == "fallback"  # still cooling down
    clock.advance(0.06)
    assert br.route() == "device"  # the half-open probe
    assert br.state == "half-open"
    assert br.route() == "fallback"  # only ONE probe at a time
    br.record_failure()  # probe failed -> open again, timer reset
    assert br.state == "open"
    clock.advance(0.11)
    assert br.route() == "device"
    br.record_success()  # probe succeeded -> closed
    assert br.state == "closed"
    moves = [(t["from"], t["to"]) for t in br.transitions]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "open"),
                     ("open", "half-open"), ("half-open", "closed")]
    with pytest.raises(ValueError, match="threshold"):
        CircuitBreaker(threshold=0)


def test_breaker_stale_outcomes_never_settle_the_probe():
    clock = FakeClock()
    br = CircuitBreaker(threshold=1, cooldown_ms=100.0, clock=clock)
    br.record_failure(probe=False)
    assert br.state == "open"
    clock.advance(0.11)
    assert br.route() == "device" and br.routed_probe  # the probe
    assert br.state == "half-open"
    br.record_success(probe=False)  # stale chunk retires: no transition
    assert br.state == "half-open" and br.probe_inflight
    br.record_failure(probe=False)  # stale failure: probe slot intact
    assert br.state == "half-open" and br.probe_inflight
    assert br.route() == "fallback" and not br.routed_probe
    br.record_success(probe=True)  # the probe's own outcome closes it
    assert br.state == "closed" and not br.probe_inflight
    moves = [(t["from"], t["to"]) for t in br.transitions]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]


def test_breaker_transition_trail_bounded_count_exact():
    clock = FakeClock()
    br = CircuitBreaker(threshold=1, cooldown_ms=1.0, clock=clock)
    br.record_failure()  # closed -> open
    flaps = TRANSITION_CAP  # each flap: open -> half-open -> open
    for _ in range(flaps):
        clock.advance(0.002)
        assert br.route() == "device"  # half-open probe
        br.record_failure()  # probe fails -> open again
    assert br.transition_count == 1 + 2 * flaps
    assert len(br.transitions) == TRANSITION_CAP
    assert br.transitions[-1]["to"] == "open"


def test_breaker_opens_routes_fallback_probes_and_recloses():
    # two consecutive device failures open the K=2 breaker; the retry and
    # the next chunks serve via the CPU fallback; after the cooldown the
    # half-open probe re-closes it — results all bitwise (on the CPU the
    # fallback sibling runs the same conv programs)
    clock = FakeClock()
    rng = np.random.default_rng(6)
    cases = _cases(4, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    engine = _engine(batch_sizes=(1,))
    with ServePipeline(engine=engine, depth=1, window_ms=0.0, clock=clock, retries=2,
                       backoff_ms=0.0, breaker_threshold=2, breaker_cooldown_ms=1000.0,
                       faults=FaultPlan.parse("raise@0,raise@1")) as pipe:
        handles = [pipe.submit(c) for c in cases[:3]]
        pipe.drain()  # case0: fail, fail (-> open), fallback-served
        m = pipe.metrics()["resilience"]
        assert m["breaker"]["state"] == "open"
        assert m["fallback_chunks"] >= 2  # case0's 3rd attempt + cases 1-2
        clock.advance(1.1)  # past the cooldown
        handles.append(pipe.submit(cases[3]))  # the half-open probe
        pipe.drain()
    m = pipe.metrics()["resilience"]
    assert m["breaker"]["state"] == "closed"
    moves = [(t["from"], t["to"]) for t in m["breaker"]["transitions"]]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    for h, want in zip(handles, offline, strict=True):
        assert np.array_equal(h.result, want)


def test_fallback_that_cannot_be_built_never_serves(monkeypatch):
    # the fallback is a declared route: a CPU sibling that cannot be built
    # fails the chunk through the supervised path (classified, quarantined
    # with the cause), never a quiet success
    def broken(self, dim):
        raise RuntimeError("no CPU sibling")

    monkeypatch.setattr(CpuFallback, "_sibling", broken)
    rng = np.random.default_rng(14)
    with _pipe(depth=1, window_ms=0.0, batch_sizes=(1,), retries=1, backoff_ms=0.0,
               breaker_threshold=1, breaker_cooldown_ms=1e6,
               faults=FaultPlan.parse("raise@0")) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        pipe.drain()
    assert h.result is None and h.error is not None
    assert "no CPU sibling" in str(h.error)
    res = pipe.metrics()["resilience"]
    assert res["fallback_chunks"] == 0 and res["faults"] == {"error": 2}


# -- real failures with the engine on the card -----------------------------
#    On the CPU the pipeline's ``on_card`` is set by hand: the stages are the
#    same, only the classification rule differs.
REAL_STAGES = ["build_program", "stage_inputs", "dispatch_chunk", "fence"]


def _break_stage(monkeypatch, engine, stage):
    def boom(*args, **kwargs):
        raise RuntimeError(f"{stage} failed")

    if stage == "fence":
        monkeypatch.setattr(server_mod, "fence_scalar", boom)
    else:
        monkeypatch.setattr(engine, stage, boom)


@pytest.mark.parametrize("deadline", [None, 60.0])
@pytest.mark.parametrize("stage", REAL_STAGES)
def test_real_failure_on_the_card_propagates_and_never_falls_back(monkeypatch, stage,
                                                                  deadline):
    # a kernel that does not build, stage, launch or finish on the card is
    # the port's fault, not the request's: no retry, no breaker, no CPU
    # fallback, and close() does not drain the broken pipeline again
    rng = np.random.default_rng(15)
    engine = _engine(batch_sizes=(1,))
    _break_stage(monkeypatch, engine, stage)
    pipe = ServePipeline(engine=engine, depth=2, window_ms=0.0, retries=2, backoff_ms=0.0,
                         breaker_threshold=1, fetch_deadline_ms=deadline)
    pipe.on_card = True
    with pytest.raises(RuntimeError, match=f"^{stage} failed$"):
        with pipe:
            for c in _cases(3, rng):
                pipe.submit(c)
            pipe.drain()
    res = pipe.metrics()["resilience"]
    assert (res["faults"], res["retries"], res["fallback_chunks"]) == ({}, 0, 0)
    assert res["breaker"]["state"] == "closed"


@pytest.mark.parametrize("stage", REAL_STAGES)
def test_real_failure_off_the_card_is_classified_as_the_jax_pipeline_does(monkeypatch,
                                                                          stage):
    rng = np.random.default_rng(16)
    engine = _engine(batch_sizes=(1,))
    _break_stage(monkeypatch, engine, stage)
    with ServePipeline(engine=engine, depth=1, window_ms=0.0, retries=1, backoff_ms=0.0,
                       fallback=False) as pipe:
        h = pipe.submit(_cases(1, rng)[0])
        pipe.drain()
    assert not pipe.on_card
    assert isinstance(h.error, ServeError) and f"{stage} failed" in str(h.error)
    res = pipe.metrics()["resilience"]
    assert res["faults"] == {"error": 2} and res["retries"] == 1


def test_injected_faults_on_the_card_open_the_breaker_and_mark_the_route():
    # injected faults still drive the breaker on the card; each handle says
    # which route served it, so a caller can tell the card's results from
    # the CPU fallback's
    clock = FakeClock()
    rng = np.random.default_rng(17)
    cases = _cases(3, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    pipe = ServePipeline(engine=_engine(batch_sizes=(1,)), depth=1, window_ms=0.0,
                         clock=clock, retries=2, backoff_ms=0.0, breaker_threshold=2,
                         breaker_cooldown_ms=1000.0, faults=FaultPlan.parse("raise@1x2"))
    pipe.on_card = True
    with pipe:
        handles = [pipe.submit(c) for c in cases]
        pipe.drain()
    res = pipe.metrics()["resilience"]
    assert res["breaker"]["state"] == "open" and res["faults"] == {"error": 2}
    assert [h.route for h in handles] == ["device", "fallback", "fallback"]
    assert res["fallback_chunks"] == 2
    for h, want in zip(handles, offline, strict=True):
        assert np.array_equal(h.result, want)


# -- the acceptance chaos run ----------------------------------------------
def _chaos(pipe_cls, cases, engine, deadline_ms=100.0):
    """The mid-stream plan against a supervised D=3 pipeline with a K=1
    breaker: 8 cases, the cooldown, then the half-open probe."""
    clock = FakeClock()
    plan = (FaultPlan if pipe_cls is ServePipeline else jfaults.FaultPlan).parse(
        "raise@1,stall@3,nan@5,nan@c6x*")
    with pipe_cls(engine=engine, depth=3, window_ms=0.0, clock=clock, retries=1,
                  backoff_ms=0.0, fetch_deadline_ms=deadline_ms, breaker_threshold=1,
                  breaker_cooldown_ms=50.0, sleep=lambda s: None, faults=plan) as pipe:
        handles = [pipe.submit(c) for c in cases[:8]]
        pipe.drain()
        opened = pipe.metrics()["resilience"]["breaker"]["state"]
        clock.advance(0.1)  # cooldown elapses
        handles.append(pipe.submit(cases[8]))  # the half-open probe
        pipe.drain()
    return pipe, handles, opened


def test_chaos_acceptance_mid_stream_faults_breaker_cycle_and_quarantine():
    """Raise at dispatch 1, stall at dispatch 3, NaN at dispatch 5, plus a
    persistent NaN following case 6: every non-poison request comes back
    bitwise the uninjected offline run, exactly case 6 raises ServeError,
    and the breaker is OBSERVED (from metrics) to open, probe half-open and
    re-close."""
    rng = np.random.default_rng(7)
    cases = _cases(9, rng)
    offline = _engine(batch_sizes=(1,)).run(cases)
    pipe, handles, opened = _chaos(ServePipeline, cases, _engine(batch_sizes=(1,)))
    assert opened == "open"  # opened at the raise
    m = pipe.metrics()
    res = m["resilience"]
    assert res["faults"]["error"] >= 1
    assert res["faults"]["hang"] >= 1
    assert res["faults"]["corrupt"] >= 2  # the transient + the poison's
    assert [q["case"] for q in res["quarantined"]] == [6]
    assert res["quarantined"][0]["classification"] == "corrupt"
    with pytest.raises(ServeError) as ei:
        handles[6].wait()
    assert ei.value.classification == "corrupt" and ei.value.case_seq == 6
    moves = [(t["from"], t["to"]) for t in res["breaker"]["transitions"]]
    assert moves == [("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    assert res["fallback_chunks"] >= 1
    for i in range(9):
        if i == 6:
            continue
        assert np.array_equal(handles[i].result, offline[i]), i
    assert "resilience" in m and "breaker" in m["resilience"]


def test_chaos_classifications_quarantine_and_breaker_match_the_jax_pipeline():
    # the same cases and plan (raise@1, stall@3 under a deadline, nan@5,
    # nan@c6x*) through both pipelines on injected clocks: the same fault
    # counts, retries, bisections, quarantined seqs, fallback chunks and
    # breaker transitions (times included), and states within 1e-12; the
    # deadline is long enough that no real fence trips it
    rng = np.random.default_rng(17)
    cases = _cases(9, rng)
    ours, oh, _ = _chaos(ServePipeline, cases, _engine(batch_sizes=(1,)), 1000.0)
    theirs, th, _ = _chaos(jserver.ServePipeline, _jax_twins(cases),
                           jens.EnsembleEngine(batch_sizes=(1,)), 1000.0)
    a, b = ours.metrics()["resilience"], theirs.metrics()["resilience"]
    for key in ("faults", "retries", "bisections", "fallback_chunks", "quarantined"):
        assert a[key] == b[key], key
    assert a["breaker"] == b["breaker"]
    for h, j in zip(oh, th, strict=True):
        assert (h.error is None) == (j.error is None)
        if h.error is None:
            assert float(np.abs(h.result - np.asarray(j.result)).max()) <= 1e-12
    assert ours.metrics()["forced_closes"] == theirs.metrics()["forced_closes"]


@pytest.mark.parametrize("spec,deadline", [("raise@1", None), ("stall@3", 1000.0),
                                            ("nan@c6x*", None)])
def test_each_fault_quarantines_the_same_seqs_as_the_jax_pipeline(spec, deadline):
    # one fault kind at a time, no retries, a 12-case stream in chunks of 2;
    # the stall's deadline is long enough that no real fence of either
    # pipeline trips it, so only the injected stall classifies a hang
    rng = np.random.default_rng(18)
    cases = _cases(12, rng)
    kw = dict(depth=2, window_ms=10_000.0, retries=0, backoff_ms=0.0, fallback=False,
              fetch_deadline_ms=deadline)
    with ServePipeline(engine=_engine(batch_sizes=(2,)), faults=FaultPlan.parse(spec),
                       **kw) as pipe:
        oh = [pipe.submit(c) for c in cases]
        pipe.drain()
    with jserver.ServePipeline(engine=jens.EnsembleEngine(batch_sizes=(2,)),
                               faults=jfaults.FaultPlan.parse(spec), **kw) as jpipe:
        th = [jpipe.submit(c) for c in _jax_twins(cases)]
        jpipe.drain()
    a, b = pipe.metrics()["resilience"], jpipe.metrics()["resilience"]
    assert a["quarantined"] == b["quarantined"] and a["faults"] == b["faults"]
    assert a["bisections"] == b["bisections"] and a["faults"]
    assert [h.error is None for h in oh] == [j.error is None for j in th]


def test_happy_path_supervision_reports_all_zero_telemetry():
    rng = np.random.default_rng(8)
    cases = _cases(6, rng)
    offline = _engine().run(cases)
    with _pipe(depth=2, window_ms=0.0) as pipe:
        served = pipe.serve_cases(cases)
    res = pipe.metrics()["resilience"]
    assert res["retries"] == 0 and res["faults"] == {}
    assert res["bisections"] == 0 and res["fallback_chunks"] == 0
    assert res["quarantined"] == [] and res["backoff_ms_total"] == 0.0
    assert res["breaker"]["state"] == "closed"
    assert res["breaker"]["transitions"] == []
    for got, want in zip(served, offline, strict=True):
        assert np.array_equal(got, want)
