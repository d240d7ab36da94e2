"""The port's ensemble engine (serve/ensemble.py) against the JAX package's.

Both engines run the same cases (the JAX ``EnsembleCase`` carried over by
convert.ensemble_case_from_jax) at the JAX suite's size (tests/
test_ensemble.py: 40x36, eps=3, 5 steps, B <= 8), the port on the CPU with
the kernels' plain versions (``method="cuda"``), the JAX package with its
Pallas kernels in interpret mode.  Every bucket kind is held to 1e-12 in
float64, relative to the largest magnitude of the result; within the port,
each lane is bitwise the port's solo solve.  Then the report's counters,
the refusals, the batched tuner on the CPU and ``--ensemble`` through each
CLI.
"""

import io
import json
import sys

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch import convert
from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.obs import metrics as obs_metrics
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp2D,
    make_batched_multi_step_fn_stacked,
    make_batched_multi_step_fn_vmap,
    make_multi_step_fn_base,
)
from nonlocalheatequation_torch.serve import ensemble as tens
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.utils import autotune
from nonlocalheatequation_tpu.serve import ensemble as jens
from tests.cases import CASES_1D, CASES_2D
from tests.test_oracle_3d import CASES_3D

torch.set_num_threads(1)

CPU = "cpu"
NX, NY, EPS, NSTEPS = 40, 36, 3, 5
MIXED = [(1.0, 1e-4, 0.02), (0.5, 2e-4, 0.02), (0.2, 1e-4, 0.01), (1.0, 5e-5, 0.03)]


def _jax_cases(n, params, seed, shape=(NX, NY), nt=NSTEPS, test=False, eps=EPS):
    rng = np.random.default_rng(seed)
    return [jens.EnsembleCase(shape=shape, nt=nt, eps=eps, k=params[i % len(params)][0],
                              dt=params[i % len(params)][1], dh=params[i % len(params)][2],
                              test=test, u0=None if test else rng.normal(size=shape))
            for i in range(n)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _solo(case, precision="f32", method="cuda"):
    """The port's solo solve of a 2D case (its Solver2D, test form or not)."""
    s = Solver2D(*case.shape, case.nt, case.eps, k=case.k, dt=case.dt, dh=case.dh,
                 method=method, precision=precision, device=CPU, dtype=torch.float64)
    if case.test:
        s.test_init()
    else:
        s.input_init(case.u0)
    return s.do_work()


# every bucket kind: (JAX engine kwargs, port engine kwargs, cases)
BUCKETS = {
    "uniform": ({}, {}, lambda: _jax_cases(8, MIXED[:1], 0)),
    "mixed": ({}, {}, lambda: _jax_cases(8, MIXED, 1)),
    "carried": ({"variant": "carried"}, {"variant": "carried"},
                lambda: _jax_cases(3, MIXED, 2)),
    "superstep": ({"variant": "superstep", "ksteps": 2},
                  {"variant": "superstep", "ksteps": 2}, lambda: _jax_cases(3, MIXED, 3)),
    "bf16": ({"precision": "bf16"}, {"precision": "bf16"}, lambda: _jax_cases(2, MIXED, 4)),
    "bf16-carried": ({"precision": "bf16", "variant": "carried"},
                     {"precision": "bf16", "variant": "carried"},
                     lambda: _jax_cases(2, MIXED, 5)),
    "test-form-uniform": ({}, {}, lambda: _jax_cases(3, MIXED[:1], 6, test=True)),
    "test-form-mixed": ({}, {}, lambda: _jax_cases(3, MIXED[:3], 7, test=True)),
    "mixed-grids-padded": ({}, {}, lambda: _jax_cases(3, MIXED[:1], 8)
                           + _jax_cases(2, MIXED, 9, shape=(48, 48))),
}


@pytest.mark.parametrize("kind", list(BUCKETS))
def test_engine_matches_the_jax_engine_2d(kind):
    jkw, tkw, make = BUCKETS[kind]
    jcases = make()
    want = jens.EnsembleEngine(method="pallas", **jkw).run(jcases)
    tcases = [convert.ensemble_case_from_jax(c) for c in jcases]
    engine = EnsembleEngine(method="cuda", device=CPU, dtype=torch.float64, **tkw)
    got = engine.run(tcases)
    for case, g, w in zip(tcases, got, want, strict=True):
        assert g.shape == case.shape and g.dtype == np.float64
        assert _rel(g, w) <= 1e-12, kind
        if "carried" not in kind and "superstep" not in kind:
            assert np.array_equal(g, _solo(case, tkw.get("precision", "f32")))


@pytest.mark.parametrize("rank", [1, 3])
def test_engine_matches_the_jax_engine_1d_3d(rank):
    rng = np.random.default_rng(10 + rank)
    if rank == 1:
        jcases = [jens.EnsembleCase(shape=(50,), nt=6, eps=5, k=k, dt=dt, dh=0.02, test=test,
                                    u0=None if test else rng.normal(size=50))
                  for k, dt in [(1.0, 1e-3), (0.5, 2e-3), (1.0, 1e-3)] for test in (False, True)]
        jkw, tkw = {}, {}
    else:
        jcases = [jens.EnsembleCase(shape=(12, 12, 12), nt=4, eps=2, k=k, dt=dt, dh=0.05,
                                    test=test, u0=None if test else rng.normal(size=(12,) * 3))
                  for k, dt in [(1.0, 1e-5), (0.5, 2e-5)] for test in (False, True)]
        jkw, tkw = {"method": "sat"}, {"method": "cuda"}
    want = jens.EnsembleEngine(**jkw).run(jcases)
    engine = EnsembleEngine(device=CPU, dtype=torch.float64, **tkw)
    got = engine.run([convert.ensemble_case_from_jax(c) for c in jcases])
    assert set(engine.report.strategies.values()) == {"vmap"}
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) <= 1e-12


def test_report_counts_programs_dispatches_and_padding():
    cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(8, MIXED, 20)]
    engine = EnsembleEngine(method="cuda", device=CPU)
    engine.run(cases)
    r = engine.report
    assert (r.cases, r.buckets, r.programs_built, r.dispatches, r.padded_cases) == (8, 1, 1, 1, 0)
    assert r.strategies == {cases[0].bucket_key(): "per-step[mixed]"}
    engine.run(cases)  # the same chunk again: the program is reused
    assert (r.programs_built, r.dispatches, r.programs_resident) == (1, 2, 1)
    # 3 + 2 cases of two grids: two buckets, the 3 padded to 4, the lane dropped
    mixed = [convert.ensemble_case_from_jax(c) for c in
             _jax_cases(3, MIXED[:1], 21) + _jax_cases(2, MIXED[:1], 22, shape=(48, 48))]
    engine = EnsembleEngine(method="cuda", device=CPU)
    res = engine.run(mixed)
    assert (engine.report.buckets, engine.report.dispatches, engine.report.padded_cases) == (2, 2, 1)
    assert len(res) == 5 and res[0].shape == (NX, NY) and res[3].shape == (48, 48)
    assert "5 cases -> 2 buckets, 2 dispatches, 2 programs built (1 padding lanes)" == \
        engine.report.summary()
    assert json.loads(engine.report.metrics_json())["padded_cases"] == 1
    reg = engine.report.registry
    assert reg.counter("/ensemble/cases").value == 5
    assert reg.gauge("/store/resident-programs").value == 2
    with pytest.raises(ValueError, match="already registered as gauge"):
        reg.counter("/store/resident-programs")
    # a bounded program cache evicts the least recently used program
    engine = EnsembleEngine(method="cuda", device=CPU, program_cache_cap=1)
    engine.run(mixed)
    assert (engine.report.programs_evicted, engine.report.programs_resident) == (1, 1)
    assert EnsembleEngine(device=CPU).sibling(variant="vmap").variant == "vmap"
    assert EnsembleEngine(device=CPU).engine_key() == ("euler", 0, "auto", "f32")


def test_engine_spans_reach_an_installed_tracer():
    clock = iter(range(100))
    tracer = obs_trace.Tracer(capacity=3, clock=lambda: float(next(clock)), pid=7)
    prev = obs_trace.set_tracer(tracer)
    try:
        cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(2, MIXED, 30)]
        EnsembleEngine(method="cuda", device=CPU).run(cases)
        EnsembleEngine(method="cuda", device=CPU).run(cases[:1] + cases)
    finally:
        obs_trace.set_tracer(prev)
    assert obs_trace.get_tracer() is prev and obs_trace.span("x") is obs_trace.NULL_SPAN
    doc = tracer.chrome_trace()
    names = [e["name"] for e in doc["traceEvents"]]
    assert tracer.spans_total == 4 and names == ["ensemble.chunk", "ensemble.build",
                                                 "ensemble.chunk"]
    assert all(e["ph"] == "X" and e["pid"] == 7 and e["dur"] > 0 for e in doc["traceEvents"])
    assert doc["traceEvents"][1]["args"]["variant"] == "auto"
    with tracer.span("probe", cat="t"):
        pass
    with pytest.raises(RuntimeError), tracer.span("fails"):
        raise RuntimeError("x")
    assert tracer.chrome_trace()["traceEvents"][-1]["args"] == {"error": "RuntimeError"}
    report = type("R", (), {"n": obs_metrics.backed("_m")})()
    report._m = obs_metrics.MetricsRegistry().gauge("/x")
    report.n += 3
    assert report._m.value == 3


def test_vmap_oracle_and_stacked_composition():
    cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(4, MIXED, 40, test=True)]
    ops = [NonlocalOp2D(c.eps, c.k, c.dt, c.dh, method="cuda") for c in cases]
    parts = [op.source_parts(NX, NY) for op in ops]
    gs, lgs = [g for g, _ in parts], [lg for _, lg in parts]
    U = torch.from_numpy(np.stack([op.spatial_profile(NX, NY) for op in ops]))
    got_v = make_batched_multi_step_fn_vmap(ops, NSTEPS, test=True, gs=gs, lgs=lgs)(U, 0)
    got_s = make_batched_multi_step_fn_stacked(ops, NSTEPS, test=True, gs=gs, lgs=lgs)(U, 0)
    for i, op in enumerate(ops):
        solo = make_multi_step_fn_base(op, NSTEPS, gs[i], lgs[i])(U[i], 0)
        assert _rel(got_v[i], solo) <= 1e-12
        assert torch.equal(got_s[i], solo)


def test_refusals(monkeypatch):
    test_cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(1, MIXED, 50, test=True)]
    prod = [convert.ensemble_case_from_jax(c) for c in _jax_cases(1, MIXED, 51)]
    with pytest.raises(ValueError, match="production-only"):
        EnsembleEngine(method="cuda", variant="carried", device=CPU).run(test_cases)
    with pytest.raises(ValueError, match="needs ksteps"):
        EnsembleEngine(method="cuda", variant="superstep", device=CPU)
    with pytest.raises(ValueError, match="needs an initial state"):
        EnsembleEngine(method="cuda", device=CPU).run(
            [EnsembleCase(shape=(NX, NY), nt=2, eps=EPS, k=1.0, dt=1e-4, dh=0.02, test=False)])
    ops = [NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, precision="bf16", resync_every=3)]
    with pytest.raises(ValueError, match="resync"):
        make_batched_multi_step_fn_vmap(ops, 2)
    with pytest.raises(ValueError, match="needs the 2D cuda method"):
        EnsembleEngine(method="conv", variant="carried", device=CPU).run(prod)
    with pytest.raises(ValueError, match="unknown ensemble variant"):
        EnsembleEngine(variant="grid", device=CPU)
    # a mesh case resolves through the mesh registry (tests/test_torch_gather.py
    # runs mesh buckets); with the registry off it is refused, as in the JAX
    # package, and convert carries its hash
    mesh = EnsembleCase(shape=(10,), nt=2, eps=0, k=1.0, dt=1e-4, dh=0.0, mesh="abc",
                        u0=np.zeros(10))
    monkeypatch.delenv("NLHEAT_MESH_DIR", raising=False)
    with pytest.raises(RuntimeError, match="no mesh registry configured"):
        EnsembleEngine(device=CPU).run([mesh])
    assert convert.ensemble_case_from_jax(mesh).mesh == "abc"
    # a stepper engine builds; a stage count rkc cannot run is refused
    assert EnsembleEngine(device=CPU, stepper="rkc", stages=4).engine_key()[:2] == ("rkc", 4)
    with pytest.raises(ValueError, match="stepper='rkc' needs stages >= 2"):
        EnsembleEngine(device=CPU, stepper="rkc", stages=1)
    # comm='fused' needs method='cuda', as the JAX engine needs method='pallas'
    with pytest.raises(ValueError, match="comm='fused' needs method='cuda'"):
        EnsembleEngine(device=CPU, comm="fused")
    with pytest.raises(ValueError, match="unknown comm"):
        EnsembleEngine(device=CPU, comm="rdma")
    # the program store (serve/program_store.py) is taken and resolved at the
    # first build; a sibling on another device keys its own backend
    stored = EnsembleEngine(device=CPU, program_store="/nonexistent/store",
                            store_backend="cpu")
    assert stored.program_store is None and stored.store_backend == "cpu"
    assert stored.sibling(method="sat").store_backend == "cpu"
    assert stored.sibling(device=CPU).store_backend is None
    with pytest.raises(ValueError, match="exceeds the top batch size"):
        EnsembleEngine(device=CPU).pad_chunk(prod * 9)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            EnsembleEngine()
    s = Solver2D(8, 8, 3, 2, device=CPU)
    s.t0 = 1
    with pytest.raises(ValueError, match="starts every case at t0=0"):
        s.ensemble_case()


def test_run_test_cases_matches_the_jax_helper():
    jcases = _jax_cases(2, MIXED, 60, test=True) + _jax_cases(1, MIXED, 61, test=True,
                                                               shape=(24, 20))
    want = jens.run_test_cases(jcases, method="pallas")
    got = tens.run_test_cases([convert.ensemble_case_from_jax(c) for c in jcases],
                              method="cuda", device=CPU)
    for (ge, gn), (we, wn) in zip(got, want, strict=True):
        # the two l2 norms differ by at most the norm of the states' difference,
        # sqrt(n) * 1e-12 for states of magnitude 1 that agree to 1e-12
        assert gn == wn and abs(np.sqrt(ge) - np.sqrt(we)) <= np.sqrt(gn) * 1e-12


def test_solver_cases_carry_their_solves():
    s2 = Solver2D(12, 10, 4, 2, k=0.5, dt=1e-4, dh=0.05, device=CPU)
    s2.test_init()
    s1 = Solver1D(30, 7, 3, k=1.0, dt=1e-3, dx=0.02, device=CPU)
    s1.input_init(np.linspace(0.0, 1.0, 30))
    c2, c1 = s2.ensemble_case(), s1.ensemble_case()
    assert (c2.shape, c2.nt, c2.eps, c2.physics(), c2.test) == ((12, 10), 4, 2,
                                                               (0.5, 1e-4, 0.05), True)
    assert (c1.shape, c1.dh, c1.test) == ((30,), 0.02, False)
    out = EnsembleEngine(device=CPU).run([c2, c1])
    for s, u in zip((s2, s1), out, strict=True):
        assert np.array_equal(u, s.do_work())


def test_batch_tuner_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(autotune, "_memory_cache", {})
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setattr(autotune, "PROBE_STEPS", 2)
    monkeypatch.setattr(autotune, "PROBE_ITERS", 1)
    monkeypatch.setenv("NLHEAT_TUNE_BATCH", "1")
    cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(4, MIXED, 70, shape=(40, 40))]
    engine = EnsembleEngine(method="cuda", device=CPU, dtype=torch.float64, ksteps=4)
    res = engine.run(cases)
    label = engine.report.strategies.popitem()[1]
    (key, entry), = autotune.records().items()
    assert key.endswith("/cpu/cuda/40x40/eps3/float64/batch4")
    assert set(entry["ms_per_step"]) == {"batched-per-step", "batched-carried",
                                        "batched-superstep2", "batched-superstep3",
                                        "batched-superstep4", "vmap"}
    assert label == f"tuned:{entry['winner']}"
    assert json.loads(cache.read_text())[key] == entry
    for case, got in zip(cases, res, strict=True):
        assert _rel(got, _solo(case)) <= 1e-12
    # a recorded winner is reused without probing again
    probes = []
    monkeypatch.setattr(autotune, "_measure_batched", lambda *a: probes.append(a) or 1.0)
    ops = [NonlocalOp2D(c.eps, c.k, c.dt, c.dh, method="cuda") for c in cases]
    _fn, winner = autotune.pick_batched_multi_step_fn(ops, 5, (40, 40), torch.float64, CPU, 4)
    assert winner == entry["winner"] and not probes
    # test-form buckets and other methods are not tuned (the JAX rule)
    test_cases = [convert.ensemble_case_from_jax(c) for c in _jax_cases(2, MIXED, 71, test=True)]
    engine = EnsembleEngine(method="cuda", device=CPU)
    engine.run(test_cases)
    assert engine.report.strategies.popitem()[1] == "per-step[mixed]"
    # the rule is read when the engine is made: later changes to the
    # environment never reach an engine's programs
    tuned = EnsembleEngine(method="cuda", device=CPU, dtype=torch.float64, ksteps=4)
    monkeypatch.delenv("NLHEAT_TUNE_BATCH")
    tuned.run(cases)
    assert tuned.report.strategies.popitem()[1] == f"tuned:{entry['winner']}" and not probes
    untuned = EnsembleEngine(method="cuda", device=CPU, dtype=torch.float64)
    monkeypatch.setenv("NLHEAT_TUNE_BATCH", "1")
    untuned.run(cases)
    assert untuned.report.strategies.popitem()[1] == "per-step[mixed]"


def test_batch_tuner_raises_on_a_failing_candidate(monkeypatch):
    from nonlocalheatequation_torch.ops import cuda_batched as cb

    monkeypatch.setattr(autotune, "_memory_cache", {})
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(autotune, "PROBE_STEPS", 2)

    def broken(*_a, **_kw):
        raise RuntimeError("batched_carried2d launch failed: cudaGetLastError 700")

    monkeypatch.setattr(cb, "make_batched_carried_multi_step_fn", broken)
    ops = [NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, method="cuda")] * 2
    with pytest.raises(RuntimeError, match="batched_carried2d launch failed"):
        autotune.pick_batched_multi_step_fn(ops, 4, (NX, NY), torch.float64, CPU)
    assert autotune.records() == {}


@pytest.mark.parametrize("lead,carried,winner,short", [
    (0.9, 2.0, "batched-per-step", None),    # 10% faster: inside the margin, per-step keeps it
    (0.7, 2.0, "batched-superstep3", None),  # 30% faster: beyond it
    # the recorded winner does not fit a 2-step run: the fitting candidates
    # by the same rule, so carried's 10% lead leaves per-step in place
    (0.7, 0.9, "batched-superstep3", "batched-per-step"),
], ids=["inside-margin", "beyond-margin", "non-fitting-record"])
def test_batch_tuner_probes_in_rounds_and_keeps_per_step_by_a_margin(monkeypatch, lead, carried,
                                                                     winner, short):
    monkeypatch.setattr(autotune, "_memory_cache", {})
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", "")
    names = ["batched-per-step", "batched-carried", "batched-superstep3", "vmap"]
    cands = [(n, lambda _o, _n, _d, n=n: n) for n in names]
    maker_name = {id(m): n for n, m in cands}
    # seconds a step: the first round's per-step probe is a spike, and the
    # rounds keep each candidate's best
    first = {"batched-per-step": 5.0, "batched-superstep3": lead, "batched-carried": carried}
    later = {"batched-per-step": 1.0, "batched-superstep3": lead, "batched-carried": carried}
    order = []

    def measure(maker, *_a):
        order.append(maker_name[id(maker)])
        return (first if len(order) <= len(names) else later).get(order[-1], 2.0)

    monkeypatch.setattr(autotune, "batched_candidates", lambda *_a: cands)
    monkeypatch.setattr(autotune, "_measure_batched", measure)
    ops = [NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, method="cuda")] * 2
    fn, got = autotune.pick_batched_multi_step_fn(ops, 6, (NX, NY), torch.float64, CPU)
    assert order == names * autotune.BATCH_PROBE_ROUNDS  # in turns, round after round
    assert (got, fn) == (winner, winner)
    (entry,) = autotune.records().values()
    assert entry["ms_per_step"] == {"batched-per-step": 1e3, "batched-carried": carried * 1e3,
                                    "batched-superstep3": lead * 1e3, "vmap": 2e3}
    if short is not None:  # superstep3 does not fit 2 steps; the record is reused, not re-probed
        monkeypatch.setattr(autotune, "batched_candidates",
                            lambda *_a: [c for c in cands if c[0] != "batched-superstep3"])
        fn, got = autotune.pick_batched_multi_step_fn(ops, 2, (NX, NY), torch.float64, CPU)
        assert (got, fn) == (short, short)
        assert len(order) == len(names) * autotune.BATCH_PROBE_ROUNDS


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


@pytest.mark.parametrize("cli,rows,extra", [
    (solve2d, CASES_2D, ["--method", "cuda"]),
    (solve2d, CASES_2D[:4], ["--method", "cuda", "--x64", "0"]),
    (solve1d, [r for r in CASES_1D if r[1] <= 500], []),
    (solve3d, CASES_3D, []),
], ids=["2d", "2d-f32", "1d", "3d"])
def test_cli_ensemble_passes(monkeypatch, capsys, cli, rows, extra):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(rows)))
    assert cli.main(["--test_batch", "--ensemble", "--platform", "cpu", *extra]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[-1] == "Tests Passed"
    assert f"ensemble: {len(rows)} cases -> " in err


def test_cli_ensemble_refusals_and_failure(monkeypatch, capsys):
    for cli in (solve1d, solve2d, solve3d):
        assert cli.main(["--ensemble", "--platform", "cpu"]) == 1
        assert "requires --test_batch" in capsys.readouterr().err
        assert cli.main(["--ensemble", "--test_batch", "--precision", "bf16", "--resync", "2",
                         "--platform", "cpu"]) == 1
        assert "--resync is not supported with --ensemble" in capsys.readouterr().err
    # a diverging row (dt far past the Euler bound) fails the contract
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([(20, 20, 40, 3, 1.0, 0.5, 0.05)])))
    assert solve2d.main(["--test_batch", "--ensemble", "--platform", "cpu"]) == 1
    assert "Tests Failed" in capsys.readouterr().out
