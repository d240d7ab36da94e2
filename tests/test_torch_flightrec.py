"""The port's flight recorder (obs/flightrec.py) against the JAX package's.

* The ring, the lifetime count, the flush-before-dump order and the dump
  document match the JAX recorder's under the same clock and events
  (tests/test_trace_fleet.py:203-256); ``from_env`` and the global install
  and restore behave alike.
* Under the same fault plan, a quarantine in the port's pipeline writes a
  postmortem with the JAX pipeline's reason, case and in-flight ledger
  fields; a breaker opening dumps too.
* ``--flight-dir`` on solve2d arms a recorder that dumps on SIGTERM before
  the process dies; ``install_sigterm`` keeps an ignored SIGTERM ignored.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from nonlocalheatequation_torch.obs import flightrec
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.resilience import CircuitBreaker
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils.faults import FaultPlan
from nonlocalheatequation_tpu.obs import flightrec as jflightrec
from nonlocalheatequation_tpu.obs.metrics import MetricsRegistry as JRegistry
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import server as jserver
from nonlocalheatequation_tpu.utils.faults import FaultPlan as JFaultPlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _drive(mod, registry_cls, box):
    clock = iter(np.arange(1, 500, dtype=float)).__next__
    rec = mod.FlightRecorder(str(box), capacity=4, clock=clock, replica=3)
    for i in range(10):
        rec.record("tick", i=i)
    reg = registry_cls()
    reg.counter("/serve/retries").inc(2)
    order = []
    rec.bind(registry=reg, inflight=lambda: order.append("ledger")
             or [{"chunk": 1, "cases": [5]}])
    rec.add_flush(lambda: order.append("flush"))
    path = rec.dump("quarantine", case=5)
    path2 = rec.dump("sigterm")
    return rec, order, path, path2


def _doc(path):
    doc = json.load(open(path))
    doc.pop("pid")
    return doc


def test_ring_dump_and_flush_order_equal_the_jax_recorder(tmp_path):
    ours, order, path, path2 = _drive(flightrec, MetricsRegistry, tmp_path / "torch")
    theirs, jorder, jpath, jpath2 = _drive(jflightrec, JRegistry, tmp_path / "jax")
    assert (len(ours), ours.events_total, ours.dumps) == (4, 10, 2)
    assert [e["i"] for e in ours.events] == [6, 7, 8, 9] == [e["seq"] for e in ours.events]
    assert list(ours.events) == list(theirs.events)
    assert order == jorder and order[0] == "flush"
    for a, b in ((path, jpath), (path2, jpath2)):
        assert os.path.basename(a).split("-pid")[0] == os.path.basename(b).split("-pid")[0]
        assert "-r3-" in a and a.endswith(b[-7:])
        assert _doc(a) == _doc(b)
    doc = _doc(path)
    assert (doc["postmortem"], doc["case"], doc["replica"]) == ("quarantine", 5, 3)
    assert doc["registry"]["/serve/retries"] == 2
    assert doc["inflight"] == [{"chunk": 1, "cases": [5]}]


def test_from_env_and_global_install_restore(tmp_path, capsys):
    assert flightrec.FlightRecorder.from_env({}) is None
    assert flightrec.get_recorder() is None  # the suite's default
    rec = flightrec.FlightRecorder.from_env({"NLHEAT_FLIGHT_DIR": str(tmp_path / "box")})
    assert rec is not None and os.path.isdir(rec.dir)
    blocker = tmp_path / "blocked"
    blocker.write_text("")
    assert flightrec.FlightRecorder.from_env({"NLHEAT_FLIGHT_DIR": str(blocker)}) is None
    assert jflightrec.FlightRecorder.from_env({"NLHEAT_FLIGHT_DIR": str(blocker)}) is None
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] and "flight recorder disabled" in err[0]
    flightrec.record("ignored")  # no recorder: dropped
    prev = flightrec.set_recorder(rec)
    try:
        flightrec.record("seen", x=1)
        assert flightrec.get_recorder() is rec
    finally:
        assert flightrec.set_recorder(prev) is rec
    assert [e["kind"] for e in rec.events] == ["seen"] and flightrec.get_recorder() is None
    # a failed dump is loud, never raised
    rec.dir = str(blocker / "nowhere")
    assert rec.dump("x") is None
    assert "flight-recorder dump (x) failed" in capsys.readouterr().err


def _quarantine_doc(mod, pipe_cls, engine, plan, box, cases, monkeypatch, log):
    monkeypatch.setenv("NLHEAT_EVENT_LOG", str(log))
    rec = mod.FlightRecorder(str(box))
    prev = mod.set_recorder(rec)
    try:
        with pipe_cls(engine=engine, depth=1, window_ms=0.0, retries=0, backoff_ms=0.0,
                      fallback=False, sleep=lambda s: None, faults=plan) as pipe:
            hs = [pipe.submit(c) for c in cases]
            pipe.drain()
    finally:
        mod.set_recorder(prev)
    pms = sorted(f for f in os.listdir(rec.dir) if f.startswith("postmortem-"))
    return hs, [json.load(open(os.path.join(rec.dir, f))) for f in pms]


def test_quarantine_postmortem_carries_the_jax_fields(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    cases = [EnsembleCase(shape=(16, 16), nt=2, eps=2, k=1.0, dt=1e-5, dh=1 / 16,
                          test=False, u0=rng.normal(size=(16, 16))) for _ in range(3)]
    jcases = [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                                test=c.test, u0=c.u0) for c in cases]
    hs, docs = _quarantine_doc(flightrec, ServePipeline,
                               EnsembleEngine(method="conv", device=CPU, batch_sizes=(1,)),
                               FaultPlan.parse("nan@c1x*"), tmp_path / "t", cases,
                               monkeypatch, tmp_path / "t.jsonl")
    jhs, jdocs = _quarantine_doc(jflightrec, jserver.ServePipeline,
                                 jens.EnsembleEngine(method="conv", batch_sizes=(1,)),
                                 JFaultPlan.parse("nan@c1x*"), tmp_path / "j", jcases,
                                 monkeypatch, tmp_path / "j.jsonl")
    assert [h.error is not None for h in hs] == [h.error is not None for h in jhs] == \
        [False, True, False]
    assert len(docs) == len(jdocs) == 1
    doc, jdoc = docs[0], jdocs[0]
    for k in ("postmortem", "case", "classification", "inflight", "events_total"):
        assert doc[k] == jdoc[k], k
    assert (doc["postmortem"], doc["case"], doc["classification"]) == \
        ("quarantine", 1, "corrupt")
    assert [e["kind"] for e in doc["events"]] == [e["kind"] for e in jdoc["events"]]
    assert "quarantine" in [e["kind"] for e in doc["events"]]
    assert doc["registry"]["/serve/quarantined"]["count"] == 1
    # the event log was flushed before the dump: the quarantine line is there
    lines = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert any(ln["event"] == "quarantine" for ln in lines)


def test_breaker_open_dumps_a_postmortem(tmp_path):
    rec = flightrec.FlightRecorder(str(tmp_path / "box"))
    prev = flightrec.set_recorder(rec)
    rng = np.random.default_rng(1)
    cases = [EnsembleCase(shape=(16, 16), nt=2, eps=2, k=1.0, dt=1e-5, dh=1 / 16,
                          test=False, u0=rng.normal(size=(16, 16))) for _ in range(4)]
    try:
        with ServePipeline(engine=EnsembleEngine(method="conv", device=CPU, batch_sizes=(2,)),
                           depth=1, window_ms=0.0, retries=2, backoff_ms=0.0,
                           breaker=CircuitBreaker(threshold=1, cooldown_ms=1e6),
                           faults=FaultPlan.parse("raise@0")) as pipe:
            hs = [pipe.submit(c) for c in cases]
            pipe.drain()
    finally:
        flightrec.set_recorder(prev)
    assert all(h.result is not None for h in hs)
    docs = [json.load(open(os.path.join(rec.dir, f))) for f in sorted(os.listdir(rec.dir))]
    assert [d["postmortem"] for d in docs] == ["breaker-open"]
    assert docs[0]["frm"] == "closed"
    assert any(e["kind"] == "breaker" for e in docs[0]["events"])


SIGTERM_CHILD = """
import sys
from nonlocalheatequation_torch.cli import solve2d
sys.exit(solve2d.main(["--test_batch", "--serve", "2", "--platform", "cpu",
                       "--flight-dir", sys.argv[1]]))
"""


def test_flight_dir_on_solve2d_dumps_on_sigterm(tmp_path):
    box = tmp_path / "box"
    child = subprocess.Popen([sys.executable, "-c", SIGTERM_CHILD, str(box)], cwd=REPO,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        # the child blocks reading its batch; the recorder exists once its
        # directory does, and the handler is armed right after
        deadline = time.monotonic() + 120
        while not box.is_dir():
            assert child.poll() is None, child.communicate()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        time.sleep(0.5)
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == -signal.SIGTERM, err
    docs = [json.load(open(box / f)) for f in os.listdir(box) if f.startswith("postmortem-")]
    assert [d["postmortem"] for d in docs] == ["sigterm"]
    assert docs[0]["events"][-1]["kind"] == "sigterm" and "registry" in docs[0]


@pytest.mark.parametrize("prior", ["ignore", "handler"])
def test_install_sigterm_chains_the_previous_disposition(tmp_path, prior):
    rec = flightrec.FlightRecorder(str(tmp_path / "box"))
    seen = []
    before = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, signal.SIG_IGN if prior == "ignore"
                  else lambda s, f: seen.append(s))
    try:
        flightrec.install_sigterm(rec)
        os.kill(os.getpid(), signal.SIGTERM)  # survives: ignored, or chained
        time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, before)
    assert rec.dumps == 1 and [e["kind"] for e in rec.events] == ["sigterm"]
    assert seen == ([] if prior == "ignore" else [signal.SIGTERM])
