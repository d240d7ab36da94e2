"""The port's SLO ledger (obs/slo.py) against the JAX package's.

* With an injected clock and the same promise/resolve sequence (picked and
  default engines, duplicates, unmatched seqs, errors, deadline misses, a
  drift excursion and its recovery), both ledgers give equal ``summary()``
  and ``axes()``, equal ``engine_axis``/``applies_per_step``, and a
  byte-equal Prometheus exposition of ``/slo/*``.
* ``ServePipeline(slo=True)`` and the JAX pipeline serve the same cases
  under ``raise@1`` and the chaos plan with equal ``/slo/*`` counts; the
  states are bitwise the port's run with the ledger off, and the ledger adds
  no fence (the fence spy counts the same).
* ``LiveRateRecorder`` folds the JAX EWMA sequence to 1e-15, writes its
  ``live`` block under the tuner's key grammar (byte-equal to
  ``autotune.tuning_key`` and to the key ``record_rate_fn`` reads), leaves
  ``ms_per_step`` alone, and ``record_rate_fn`` then reports ``"live"``.
"""

import json
import math

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.obs import slo as S
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.serve import picker as tpicker
from nonlocalheatequation_torch.serve import server as server_mod
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.picker import EngineChoice, record_rate_fn
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils import autotune
from nonlocalheatequation_torch.utils.faults import FaultPlan
from nonlocalheatequation_tpu.obs import slo as JS
from nonlocalheatequation_tpu.obs.metrics import MetricsRegistry as JRegistry
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import picker as jpicker
from nonlocalheatequation_tpu.serve import server as jserver
from nonlocalheatequation_tpu.utils.faults import FaultPlan as JFaultPlan

CPU = "cpu"


def _choice(mod, est_ms=2.0, stepper="rkc", stages=8, method="fft", precision="bf16"):
    return mod.EngineChoice(stepper=stepper, stages=stages, method=method,
                            precision=precision, dt=1e-5, steps=100, est_ms=est_ms,
                            est_err=1e-9, rates="records")


def _script(led, choice):
    """One promise/resolve sequence: picked and default engines, a mesh
    axis, deadline hits and misses, an error, a duplicate, an unmatched
    seq, a drift excursion (10x the model) and its recovery."""
    seq = 0
    for i in range(6):
        led.promise(seq, engine=choice(est_ms=2.0), deadline_ms=1000.0, t=0.0)
        led.resolve(seq, latency_s=0.010 + 0.001 * i, queue_wait_s=0.002, device_ms=2.2)
        seq += 1
    for i in range(3):
        led.promise(seq, deadline_ms=5.0, mesh="abcdef0123456789", t=0.0)
        led.resolve(seq, latency_s=0.050 if i else 0.001)
        seq += 1
    led.promise(seq, engine_sel=("euler", 0, "sat", "f32"), deadline_ms=1e6, t=0.0)
    led.resolve(seq, latency_s=0.001, error="corrupt")
    led.resolve(seq, latency_s=0.001)  # duplicate
    led.resolve(999, latency_s=0.001)  # unmatched
    seq += 1
    for ms in [10.0] * 12 + [1.0] * 30 + [0.01] * 30:
        led.promise(seq, engine=choice(est_ms=1.0, stepper="euler", stages=0,
                                       method="sat", precision="f32"), t=0.0)
        led.resolve(seq, latency_s=0.001, device_ms=ms, err_l2=1e-9)
        seq += 1
    led.promise(seq, deadline_ms=1.0, t=0.0)  # left open


def _slo_prometheus(reg) -> str:
    return "\n".join(ln for ln in reg.prometheus().splitlines() if "slo" in ln)


def test_ledger_summary_axes_and_exposition_equal_the_jax_ledger(capsys):
    ours = S.SloLedger(MetricsRegistry(), window=32, band=(0.5, 2.0), min_samples=4,
                       live=False, clock=lambda: 0.0)
    theirs = JS.SloLedger(JRegistry(), window=32, band=(0.5, 2.0), min_samples=4,
                          live=False, clock=lambda: 0.0)
    _script(ours, lambda **kw: _choice(tpicker, **kw))
    _script(theirs, lambda **kw: _choice(jpicker, **kw))
    assert ours.summary() == theirs.summary()
    assert ours.axes() == theirs.axes()
    s = ours.summary()
    assert (s["duplicate"], s["unmatched"], s["errors"], s["open"]) == (1, 1, 1, 1)
    assert s["drift_warnings"] == 2 and s["deadline_miss"] == 3
    assert _slo_prometheus(ours.registry) == _slo_prometheus(theirs.registry)
    assert capsys.readouterr().err.count("cost-model drift") == 4  # twice each


@pytest.mark.parametrize("sel,mesh", [(None, None), (("euler", 0, "sat", "f32"), None),
                                      (("rkc", 16, "fft", "bf16"), "abcdef0123456789"),
                                      (None, "ff")])
def test_engine_axis_and_applies_per_step_equal_the_jax_functions(sel, mesh):
    assert S.engine_axis(sel, mesh=mesh) == JS.engine_axis(sel, mesh=mesh)
    for stepper, stages in (("euler", 0), ("rkc", 16), ("expo", 2), ("expo", 0)):
        assert S.applies_per_step(stepper, stages) == JS.applies_per_step(stepper, stages)


def test_from_arg_contract_and_env_knobs(monkeypatch):
    led = S.SloLedger(live=False)
    assert S.SloLedger.from_arg(led) is led
    assert S.SloLedger.from_arg(False) is None
    assert S.SloLedger.from_arg(None) is None
    monkeypatch.setenv("NLHEAT_SLO", "1")
    reg = MetricsRegistry()
    built = S.SloLedger.from_arg(None, registry=reg, live=False)
    assert isinstance(built, S.SloLedger) and built.registry is reg
    monkeypatch.setenv("NLHEAT_SLO_BAND", "0.5,2")
    monkeypatch.setenv("NLHEAT_SLO_WINDOW", "16")
    monkeypatch.setenv("NLHEAT_SLO_MIN", "3")
    knobbed = S.SloLedger()
    assert (knobbed.band, knobbed.window, knobbed.min_samples) == ((0.5, 2.0), 16, 3)
    assert knobbed.ensure_live("cpu") is not None
    monkeypatch.setenv("NLHEAT_SLO_LIVE", "0")
    assert S.SloLedger().ensure_live("cpu") is None
    for name, bad in (("NLHEAT_SLO_BAND", "2,1"), ("NLHEAT_SLO_WINDOW", "0"),
                      ("NLHEAT_SLO_MIN", "x")):
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=name):
            S.SloLedger()
        monkeypatch.delenv(name)


def test_live_rates_fold_the_jax_ewma_under_the_tuner_key(tmp_path, monkeypatch):
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    ours = S.LiveRateRecorder("cpu", flush_every=1)
    theirs = JS.LiveRateRecorder("cpu", version="t", flush_every=1)
    shape, eps = (64, 64), 8
    key = ours.key("cuda", shape, eps, "f32")
    # one grammar: the tuner's tuning_key, and the key record_rate_fn reads
    op = NonlocalOp2D(eps, 1.0, 1e-5, 1.0 / 64)
    assert key == autotune.tuning_key(op, shape, torch.float32, CPU)
    assert key == autotune.record_key("cpu", "cuda", shape, eps, "float32")
    assert S.LiveRateRecorder("cpu", dtype_name="float64").key("cuda", shape, eps, "bf16") \
        == autotune.tuning_key(op.with_precision("bf16"), shape, torch.float64, CPU)
    # a tuner record already there keeps its election fields
    autotune._store_file_cache({key: {"winner": "carried", "ms_per_step": {"per-step": 9.0,
                                                                          "carried": 5.0}}})
    seq = [3.0, 7.0, 4.5, 4.1, 3.9, float("nan"), -1.0, 4.2, 4.0, 0.5]
    for ms in seq:
        ours.record("cuda", shape, eps, "f32", ms)
        theirs.record("cuda", shape, eps, "f32", ms)
        a = ours._acc[key]
        b = theirs._acc[theirs.key("cuda", shape, eps, "f32")]
        assert a["n"] == b["n"]
        assert math.isclose(a["ms"], b["ms"], rel_tol=1e-15, abs_tol=0.0)
    ours.flush()
    cache = json.loads((tmp_path / "autotune.json").read_text())
    entry = cache[key]
    assert entry["winner"] == "carried" and entry["ms_per_step"]["per-step"] == 9.0
    jlive = cache[theirs.key("cuda", shape, eps, "f32")]["live"]
    assert entry["live"] == {"per-step": jlive["per-step"], "n": 8, "provenance": "live"}
    rate = record_rate_fn("cpu")
    assert rate.provenance == "live"
    assert rate("cuda", shape, eps, "f32") == entry["live"]["per-step"]
    # without a live block the probed per-step rate, else the analytic proxy
    assert record_rate_fn("cpu", dtype_name="float64")("cuda", shape, eps, "f32") == \
        jpicker.analytic_rate_fn("auto", shape, eps, "f32")
    # a fresh recorder seeds its EWMA from the persisted live rate
    again = S.LiveRateRecorder("cpu", flush_every=1)
    again.record("cuda", shape, eps, "f32", 10.0)
    assert math.isclose(again._acc[key]["ms"],
                        entry["live"]["per-step"] + S.LIVE_ALPHA * (10.0 - entry["live"][
                            "per-step"]), rel_tol=1e-15)


def _cases(n, seed=0, grid=16, nt=3):
    rng = np.random.default_rng(seed)
    return [EnsembleCase(shape=(grid, grid), nt=nt + (i % 2), eps=2, k=1.0, dt=1e-5,
                         dh=1.0 / grid, test=False, u0=rng.normal(size=(grid, grid)))
            for i in range(n)]


def _serve(pipe, cases, deadline_ms):
    hs = [pipe.submit(c, deadline_ms=deadline_ms) for c in cases]
    pipe.drain()
    return hs


@pytest.mark.parametrize("plan", ["raise@1", "raise@1,stall@3,nan@c6x*"])
def test_pipeline_ledger_counts_equal_the_jax_pipeline(plan, monkeypatch):
    cases = _cases(10)
    jcases = [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                                test=c.test, u0=c.u0) for c in cases]
    common = dict(depth=2, window_ms=0.0, retries=1, backoff_ms=0.0, fallback=False,
                  clock=lambda: 0.0)
    with ServePipeline(engine=EnsembleEngine(method="conv", device=CPU, batch_sizes=(4,)),
                       faults=FaultPlan.parse(plan), slo=True, **common) as pipe:
        hs = _serve(pipe, cases, 50.0)
    with jserver.ServePipeline(engine=jens.EnsembleEngine(method="conv", batch_sizes=(4,)),
                               faults=JFaultPlan.parse(plan), slo=True, **common) as jpipe:
        _serve(jpipe, jcases, 50.0)
    ours, theirs = pipe.metrics()["slo"], jpipe.metrics()["slo"]
    for k in ("promised", "resolved", "open", "errors", "duplicate", "unmatched",
              "deadline_hit", "deadline_miss", "deadline_hit_rate", "burn", "axes"):
        assert ours[k] == theirs[k], k
    assert ours["promised"] == ours["resolved"] == len(cases) and ours["duplicate"] == 0
    assert _slo_prometheus(pipe.registry).count("\n") == \
        _slo_prometheus(jpipe.registry).count("\n")
    # the states are bitwise the port's run with the ledger off, and the
    # ledger adds no fence
    fences = []
    real = server_mod.fence_scalar
    monkeypatch.setattr(server_mod, "fence_scalar", lambda x: fences.append(1) or real(x))
    with ServePipeline(engine=EnsembleEngine(method="conv", device=CPU, batch_sizes=(4,)),
                       faults=FaultPlan.parse(plan), slo=False, **common) as off:
        hs_off = _serve(off, cases, 50.0)
    n_off = len(fences)
    with ServePipeline(engine=EnsembleEngine(method="conv", device=CPU, batch_sizes=(4,)),
                       faults=FaultPlan.parse(plan), slo=True, **common) as on:
        hs_on = _serve(on, cases, 50.0)
    assert len(fences) == 2 * n_off
    for a, b, c in zip(hs, hs_off, hs_on, strict=True):
        assert (a.result is None) == (b.result is None) == (c.result is None)
        if b.result is not None:
            assert np.array_equal(a.result, b.result) and np.array_equal(c.result, b.result)


def test_pipeline_records_live_rates_of_device_chunks(tmp_path, monkeypatch):
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    cases = [c for c in _cases(8, nt=3) if c.nt == 3]
    clock = iter(np.arange(0.0, 100.0, 0.25)).__next__
    with ServePipeline(engine=EnsembleEngine(method="conv", device=CPU), depth=1,
                       window_ms=0.0, clock=clock, slo=True) as pipe:
        picked = EngineChoice(stepper="euler", stages=0, method="conv", precision="f32",
                              dt=1e-5, steps=3, est_ms=1.0, est_err=1e-12, rates="analytic")
        for c in cases:
            pipe.submit(c, engine=picked)
        pipe.drain()
    s = pipe.metrics()["slo"]
    assert s["resolved"] == 4 and s["axes"] == {"euler[s=0]/conv/f32": {
        "requests": 4, "deadline_hit": 0, "deadline_miss": 0, "hit_rate": None}}
    cache = json.loads((tmp_path / "autotune.json").read_text())
    key = autotune.record_key("cpu", "conv", (16, 16), 2, "float64")
    assert cache[key]["live"]["provenance"] == "live" and cache[key]["live"]["n"] >= 1
    assert cache[key]["live"]["per-step"] > 0
