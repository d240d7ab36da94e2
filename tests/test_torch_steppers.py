"""The port's stepper tier (models/steppers.py: euler, rkc, expo) against the
JAX package's, on the CPU in float64.

* The stability model (``rkc_beta``, ``stable_dt``, ``stable_dt_op``,
  ``_rkc_coeffs``, ``superstep_floor``) equals the JAX package's for s in
  2..12.
* rkc and expo (S=0 and S=1) steps and multi-step runs within 1e-12 of the
  JAX ones: rkc in 2D on ``cuda`` (its kernels' plain versions here),
  ``conv`` and ``fft``, in 1D on ``shift`` and ``fft``, in 3D on ``sat``
  and ``fft``; the JAX side runs conv/shift/sat/fft, never Pallas.
* The manufactured contract of ``tests/test_spectral.py`` for each
  (method, stepper) pair (``pallas`` read as the port's ``cuda``); expo as
  the limit of Euler and unconditionally stable; the refusals in the JAX
  package's words; the gauges, span and counter; the tuner's method and
  precision dimensions; the stacked rkc ensemble bucket (JAX's engine to
  1e-12, the solo solves bitwise); the CLIs' stepper surface
  (``tests/test_cli.py``'s stdout, stderr and rc) and parsers; a JAX rkc
  state resumed by the port.
"""

import contextlib
import io
import math
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
from nonlocalheatequation_torch.convert import solver2d_from_jax_state
from nonlocalheatequation_torch.models import steppers as TSt
from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops import constants as TC
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp1D, NonlocalOp2D, NonlocalOp3D
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.utils import autotune
from nonlocalheatequation_tpu.cli import solve1d as jsolve1d
from nonlocalheatequation_tpu.cli import solve2d as jsolve2d
from nonlocalheatequation_tpu.cli import solve3d as jsolve3d
from nonlocalheatequation_tpu.models import steppers as JSt
from nonlocalheatequation_tpu.models.solver1d import Solver1D as JaxSolver1D
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D
from nonlocalheatequation_tpu.ops import constants as JC
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp1D as JaxOp1D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp3D as JaxOp3D
from nonlocalheatequation_tpu.serve import ensemble as jens
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)

CPU = "cpu"
F64 = torch.float64
T_OPS = {1: NonlocalOp1D, 2: NonlocalOp2D, 3: NonlocalOp3D}
J_OPS = {1: JaxOp1D, 2: JaxOp2D, 3: JaxOp3D}
#: the port's methods and the JAX method each is held to (never Pallas)
JAX_METHOD = {"cuda": "conv", "conv": "conv", "shift": "shift", "sat": "sat", "fft": "fft"}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _ops(dim, eps, dt, h, method):
    return (T_OPS[dim](eps, 1.0, dt, h, method=method),
            J_OPS[dim](eps, 1.0, dt, h, method=JAX_METHOD[method]))


# -- the stability model ---------------------------------------------------------------

@pytest.mark.parametrize("s", range(2, 13))
def test_stability_model_equals_jax(s):
    assert TC.rkc_beta(s) == JC.rkc_beta(s)
    w0 = 1.0 + TC.RKC_DAMPING / (s * s)
    assert TC.RKC_DAMPING == JC.RKC_DAMPING and TC._cheb_pair(s, w0) == JC._cheb_pair(s, w0)
    assert TSt._rkc_coeffs(s) == JSt._rkc_coeffs(s)
    for dim, eps, h in ((1, 5, 0.02), (2, 8, 1.0 / 4096), (3, 4, 1.0 / 256)):
        op, jop = _ops(dim, eps, 1e-5, h, "fft")
        for stepper in ("euler", "rkc", "expo"):
            assert TC.stable_dt_op(op, stepper, s) == JC.stable_dt_op(jop, stepper, s)
            for horizon in (1e-4, 6.2e-5, 0.0225):
                assert (TSt.superstep_floor(op, horizon, stepper, s)
                        == JSt.superstep_floor(jop, horizon, stepper, s))


def test_stable_dt_model():
    op = NonlocalOp2D(5, 1.0, 1.0, 0.02)
    euler = TC.stable_dt_op(op, "euler")
    assert euler == pytest.approx(1.0 / (op.c * op.dh ** 2 * op.wsum))
    assert TC.rkc_beta(2) == pytest.approx(8, rel=0.05)
    assert TC.rkc_beta(10) == pytest.approx(200, rel=0.05)
    assert TC.rkc_beta(5) < TC.rkc_beta(6)
    assert TC.stable_dt_op(op, "rkc", 8) == pytest.approx(euler * TC.rkc_beta(8) / 2.0)
    assert TC.stable_dt_op(op, "expo") == np.inf
    assert TC.stable_dt(0.0, 0.01, 1, 81.0) == np.inf  # the truncated 1D constant
    assert TC.BF16_TUNE_GATE == JC.BF16_TUNE_GATE
    with pytest.raises(ValueError, match="unknown stepper 'leapfrog'"):
        TC.stable_dt(1.0, 0.02, 2, 81.0, stepper="leapfrog")
    with pytest.raises(ValueError, match="RKC needs stages >= 2"):
        TC.rkc_beta(1)
    # the headline: 4096^2 eps=8 needs 9 rkc[8] steps to 500 Euler steps at 0.8x
    hop = NonlocalOp2D(8, 1.0, 1.0, 1.0 / 4096)
    horizon = 500 * 0.8 * TC.stable_dt_op(hop)
    assert TSt.superstep_floor(hop, horizon, "rkc", 8) == 9
    assert TSt.superstep_floor(hop, horizon, "expo") == 1
    seen = []
    assert TSt.min_steps_to_target(lambda n: 1.0 / n, 3, 100, 0.05,
                                   log=lambda n, e: seen.append(n)) == 24
    assert seen == [3, 6, 12, 24]
    assert TSt.min_steps_to_target(lambda n: 1.0, 3, 20, 0.05) == 20


# -- rkc and expo against the JAX package ------------------------------------------------

RKC_CASES = [(2, "cuda", (20, 18), 3), (2, "conv", (20, 18), 3), (2, "fft", (20, 18), 3),
             (1, "shift", (40,), 5), (1, "fft", (40,), 5),
             (3, "sat", (9, 8, 7), 2), (3, "fft", (9, 8, 7), 2)]


@pytest.mark.parametrize("dim,method,shape,eps", RKC_CASES)
@pytest.mark.parametrize("test", [False, True])
def test_rkc_matches_jax(dim, method, shape, eps, test):
    h = 1.0 / shape[0]
    probe, _ = _ops(dim, eps, 1.0, h, method)
    dt = 0.8 * TC.stable_dt_op(probe, "rkc", 4)  # ~7x the Euler bound
    op, jop = _ops(dim, eps, dt, h, method)
    u = np.random.default_rng(dim).normal(size=shape)
    g = lg = None
    if test:
        g, lg = jop.source_parts(*shape)
    jstep = JSt.make_step_fn(jop, g, lg, jnp.float64, stepper="rkc", stages=4)
    tstep = TSt.make_step_fn(op, g, lg, F64, stepper="rkc", stages=4)
    assert _rel(tstep(torch.from_numpy(u), 3), jstep(jnp.asarray(u), 3)) <= 1e-12
    want = JSt.make_multi_step_fn(jop, 5, g, lg, jnp.float64, stepper="rkc", stages=4)(
        jnp.asarray(u), 2)
    ut = torch.from_numpy(u)
    got = TSt.make_multi_step_fn(op, 5, g, lg, F64, stepper="rkc", stages=4)(ut, 2)
    assert _rel(got, want) <= 1e-12
    assert np.array_equal(ut.numpy(), u)  # multi never writes its input


@pytest.mark.parametrize("dim,shape", [(1, (48,)), (2, (20, 22))])
@pytest.mark.parametrize("stages", [0, 1])
@pytest.mark.parametrize("test", [False, True])
def test_expo_matches_jax(dim, shape, stages, test):
    h = 1.0 / shape[0]
    probe, _ = _ops(dim, 3, 1.0, h, "fft")
    dt = 6 * TC.stable_dt_op(probe)  # past the Euler bound: expo is stable there
    op, jop = _ops(dim, 3, dt, h, "fft")
    u = np.random.default_rng(7).normal(size=shape)
    g, lg = jop.source_parts(*shape) if test else (None, None)
    want = JSt.make_multi_step_fn(jop, 4, g, lg, jnp.float64, stepper="expo",
                                  stages=stages)(jnp.asarray(u), 1)
    got = TSt.make_multi_step_fn(op, 4, g, lg, F64, stepper="expo", stages=stages)(
        torch.from_numpy(u), 1)
    assert _rel(got, want) <= 1e-12
    # the tables: float64 on the host, equal to the JAX package's before the cast
    jt = JSt._expo_tables(jop, shape, jnp.float64, sub_dt=dt / max(1, stages),
                          correction=bool(stages))
    tt = TSt._expo_tables(op, shape, F64, CPU, sub_dt=dt / max(1, stages),
                          correction=bool(stages))
    assert len(tt) == len(jt) and all(np.array_equal(a.numpy(), np.asarray(b))
                                      for a, b in zip(tt, jt, strict=True))
    t32 = TSt._expo_tables(op, shape, torch.float32, CPU)
    assert all(t.dtype == torch.float32 for t in t32)


# -- the manufactured contract for each (method, stepper) pair ---------------------------

@pytest.mark.parametrize("method,stepper,stages", [
    ("conv", "euler", 0), ("sat", "euler", 0), ("fft", "euler", 0),
    ("cuda", "rkc", 4), ("conv", "rkc", 8), ("fft", "rkc", 8),
])
def test_manufactured_gate_2d(method, stepper, stages):
    s = Solver2D(50, 50, 45, 5, k=1.0, dt=0.0005, dh=0.02, method=method, stepper=stepper,
                 stages=stages, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / (50 * 50) <= L2_THRESHOLD, (method, stepper, s.error_l2)


@pytest.mark.parametrize("stages", [0, 1])
def test_manufactured_gate_2d_expo(stages):
    # the JAX gate: dt at 0.25x the Euler bound, inside expo's boundary envelope
    dt = 0.25 * TC.stable_dt_op(NonlocalOp2D(5, 1.0, 1.0, 1.0 / 128))
    s = Solver2D(128, 128, 45, 5, k=1.0, dt=dt, dh=1.0 / 128, method="fft", stepper="expo",
                 stages=stages, device=CPU)
    s.test_init()
    u = s.do_work()
    assert s.error_l2 / (128 * 128) <= L2_THRESHOLD, s.error_l2
    assert np.isfinite(u).all() and np.abs(u).max() <= np.abs(s.u0).max() * 1.01


@pytest.mark.parametrize("method,stepper,stages", [
    ("shift", "euler", 0), ("fft", "euler", 0), ("fft", "rkc", 8), ("shift", "rkc", 4),
])
def test_manufactured_gate_1d(method, stepper, stages):
    s = Solver1D(50, 45, 5, k=1.0, dt=0.001, dx=0.02, method=method, stepper=stepper,
                 stages=stages, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / 50 <= L2_THRESHOLD, (method, stepper, s.error_l2)


@pytest.mark.parametrize("method,stepper,stages", [
    ("sat", "euler", 0), ("fft", "euler", 0), ("fft", "rkc", 4), ("cuda", "rkc", 4),
])
def test_manufactured_gate_3d(method, stepper, stages):
    s = Solver3D(16, 16, 16, 20, 3, k=1.0, dt=0.0005, dh=0.0625, method=method,
                 stepper=stepper, stages=stages, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / 16 ** 3 <= L2_THRESHOLD, (method, stepper, s.error_l2)


def test_rkc_superstep_past_euler_bound():
    # the reference's 45 steps at dt=5e-4 as 5 steps at 9x that dt
    s = Solver2D(50, 50, 5, 5, k=1.0, dt=0.0045, dh=0.02, method="conv", stepper="rkc",
                 stages=8, device=CPU)
    s.test_init()
    s.do_work()
    assert s.error_l2 / (50 * 50) <= L2_THRESHOLD, s.error_l2


def test_expo_exact_limit_of_euler():
    # on a state clear of the boundary, over-resolved Euler converges first
    # order to one expo step 24x the Euler bound
    n, eps = 128, 3
    h = 1.0 / n
    T = 24 * TC.stable_dt_op(NonlocalOp1D(eps, 1.0, 1.0, h))
    x = np.arange(n)
    u0 = torch.from_numpy(np.exp(-((x - n / 2) ** 2) / (2 * 4.0 ** 2)))
    e1 = TSt.make_multi_step_fn(NonlocalOp1D(eps, 1.0, T, h, method="fft"), 1, dtype=F64,
                                stepper="expo")(u0, 0).numpy()
    errs = []
    for N in (250, 500, 1000):
        eu = TSt.make_multi_step_fn(NonlocalOp1D(eps, 1.0, T / N, h), N, dtype=F64)(u0, 0)
        errs.append(np.abs(e1 - eu.numpy()).max())
    assert errs[0] / errs[1] == pytest.approx(2.0, rel=0.02)
    assert errs[1] / errs[2] == pytest.approx(2.0, rel=0.02)


def test_expo_one_step_any_horizon_unconditionally_stable():
    n, eps = 64, 4
    h = 1.0 / n
    dt_e = TC.stable_dt_op(NonlocalOp1D(eps, 1.0, 1.0, h))
    op = NonlocalOp1D(eps, 1.0, 200 * dt_e, h, method="fft")
    u0 = np.random.default_rng(0).normal(size=n)
    out = TSt.make_multi_step_fn(op, 3, dtype=F64, stepper="expo")(torch.from_numpy(u0), 0)
    assert torch.isfinite(out).all()
    assert float(out.abs().max()) <= np.abs(u0).max() * 1.01


# -- refusals ---------------------------------------------------------------------------

def _message(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_refusals_in_jax_words():
    op = NonlocalOp2D(5, 1.0, 1.0, 0.02)
    bound = TC.stable_dt_op(op, "rkc", 4)
    for dt, stages in ((bound * 1.01, 4), (bound * 0.99, 1), (bound * 0.99, 0)):
        assert (_message(TSt.validate_stepper, NonlocalOp2D(5, 1.0, dt, 0.02), "rkc", stages)
                == _message(JSt.validate_stepper, JaxOp2D(5, 1.0, dt, 0.02), "rkc", stages))
    TSt.validate_stepper(NonlocalOp2D(5, 1.0, bound * 0.99, 0.02), "rkc", 4)  # accepted
    assert "RKC stability bound" in _message(
        TSt.validate_stepper, NonlocalOp2D(5, 1.0, bound * 1.01, 0.02), "rkc", 4)
    for method in ("conv", "cuda", "auto"):
        assert "requires method='fft'" in _message(
            TSt.validate_stepper, NonlocalOp2D(5, 1.0, 1e-4, 0.02, method=method), "expo")
    assert (_message(TSt.validate_stepper, op, "expo")
            == _message(JSt.validate_stepper, JaxOp2D(5, 1.0, 1.0, 0.02), "expo"))
    assert (_message(TSt.validate_stepper, op, "leapfrog")
            == _message(JSt.validate_stepper, JaxOp2D(5, 1.0, 1.0, 0.02), "leapfrog"))
    TSt.validate_stepper(op, "euler", 4)  # euler ignores a stage count, as in JAX
    with pytest.raises(ValueError, match="backend='oracle' is Euler-only"):
        Solver2D(20, 20, 5, 3, backend="oracle", stepper="rkc", stages=4, device=CPU)
    with pytest.raises(ValueError, match="backend='oracle' is Euler-only"):
        Solver1D(20, 5, 3, backend="oracle", method="fft", stepper="expo", device=CPU)
    with pytest.raises(ValueError, match="requires method='fft'"):
        Solver3D(8, 8, 8, 2, 2, stepper="expo", device=CPU)
    with pytest.raises(ValueError, match="needs stages >= 2"):
        TSt.make_multi_step_fn(op, 2, stepper="rkc", stages=1)


# -- observability and the tuner's dimensions --------------------------------------------

def test_stepper_gauges_span_and_fft_counter():
    op = NonlocalOp2D(3, 1.0, 1e-4, 1.0 / 24, method="fft")
    counter = REGISTRY.counter("/op/fft-applies")
    before = counter.value
    tracer = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tracer)
    try:
        multi = TSt.make_multi_step_fn(op, 4, dtype=F64, stepper="rkc", stages=4)
        multi(torch.zeros(24, 24, dtype=F64), 0)
    finally:
        obs_trace.set_tracer(prev)
    assert REGISTRY.gauge("/stepper/stages").value == 4
    assert REGISTRY.gauge("/stepper/eff-dt").value == pytest.approx(1e-4)
    assert counter.value == before + 16  # 4 steps of 4 stages, one apply each
    spans = [ev for ev in tracer.chrome_trace()["traceEvents"]
             if ev["name"] == "stepper.superstep"]
    assert len(spans) == 1
    assert spans[0]["args"] == {"stepper": "rkc", "stages": 4, "steps": 4, "eff_dt": 1e-4}
    TSt.make_multi_step_fn(op, 2, dtype=F64, stepper="expo")
    assert REGISTRY.gauge("/stepper/stages").value == 1


def test_tune_method_picks_and_runs(monkeypatch, tmp_path):
    monkeypatch.setenv("NLHEAT_TUNE_METHOD", "1")
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    autotune.reset()
    op = NonlocalOp2D(9, 1.0, 1e-5, 1.0 / 32, method="conv")
    jop = JaxOp2D(9, 1.0, 1e-5, 1.0 / 32, method="conv")
    u0 = np.random.default_rng(3).normal(size=(32, 32))
    got = TSt.make_multi_step_fn(op, 6, dtype=F64)(torch.from_numpy(u0), 0)
    monkeypatch.delenv("NLHEAT_TUNE_METHOD")
    want = JSt.make_multi_step_fn(jop, 6, dtype=jnp.float64)(jnp.asarray(u0), 0)
    assert _rel(got, want) <= 1e-12
    entry = next(v for k, v in autotune.records().items() if "method-ab" in k)
    assert set(entry["ms_per_step"]) == {"conv", "fft"} and entry["winner"] in ("conv", "fft")
    assert "conv-vs-fft" in (tmp_path / "tune.json").read_text()
    # a test-form solve, an fft op and a weighted J are never swapped
    monkeypatch.setenv("NLHEAT_TUNE_METHOD", "1")
    assert TSt._maybe_tune_method(op, np.zeros((2, 2))) is None
    assert TSt._maybe_tune_method(op.with_method("fft"), None) is None
    assert TSt._maybe_tune_method(
        NonlocalOp2D(3, 1.0, 1e-5, 0.1, influence=lambda r: 1.0 / (1 + r)), None) is None
    autotune.reset()


def test_tune_precision_dimension_and_gate(monkeypatch):
    monkeypatch.setenv("NLHEAT_TUNE_PRECISION", "1")
    autotune.reset()
    op = NonlocalOp2D(3, k=1.0, dt=1e-6, dh=1.0 / 24, method="cuda")
    # candidates are probed in order, the f32 ones first: the first bf16 one,
    # per-step+bf16, is made to win the probe
    n_f32 = len(autotune.candidates(op, (24, 24), 6, F64, CPU))
    probed = []

    def measure(maker, op_, u):
        probed.append(maker)
        return 0.5 if len(probed) == n_f32 + 1 else 1.0

    monkeypatch.setattr(autotune, "_measure", measure)
    monkeypatch.setattr(autotune, "_bf16_gate",
                        lambda *a, **kw: {"l2_per_n": 0.0, "budget": 1.0, "ok": True})
    fn, winner = autotune.pick_multi_step_fn(op, 6, (24, 24), F64, CPU)
    entry = next(iter(autotune.records().values()))
    assert any(n.endswith("+bf16") for n in entry["ms_per_step"])
    assert "resident+bf16" not in entry["ms_per_step"]  # no bf16 resident candidate
    assert winner == "per-step+bf16" and entry["bf16_gate"]["ok"] is True
    u = torch.from_numpy(np.random.default_rng(2).normal(size=(24, 24)))
    want = TSt.make_multi_step_fn(op.with_precision("bf16"), 6, dtype=F64)(u, 0)
    assert _rel(fn(u, 0), want) <= 1e-12
    # the gate failed: the same timings, but the tier may not win
    autotune.reset()
    probed.clear()
    monkeypatch.setattr(autotune, "_bf16_gate",
                        lambda *a, **kw: {"l2_per_n": 1.0, "budget": 1e-5, "ok": False})
    fn, winner = autotune.pick_multi_step_fn(op, 6, (24, 24), F64, CPU)
    assert not winner.endswith("+bf16")
    # the real gate on the probe: the bf16 tier's drift is inside the budget
    monkeypatch.undo()
    gate = autotune._bf16_gate(op, op.with_precision("bf16"), (24, 24), torch.float32, CPU)
    assert gate["ok"] and 0.0 < gate["l2_per_n"] <= TC.BF16_TUNE_GATE == gate["budget"]
    autotune.reset()


# -- the ensemble engine's stepper buckets -----------------------------------------------

PHYSICS = [(1.0, 2e-4), (0.5, 3e-4), (0.8, 1e-4)]


def _cases(test=True, method_shape=(24, 24)):
    return [EnsembleCase(shape=method_shape, nt=6, eps=3, k=k, dt=dt, dh=1.0 / 24, test=test)
            for k, dt in PHYSICS]


@pytest.mark.parametrize("method", ["fft", "cuda"])
def test_stacked_rkc_bucket_matches_jax_and_solo_bitwise(method):
    cases = _cases()
    engine = EnsembleEngine(method=method, stepper="rkc", stages=4, device=CPU, dtype=F64)
    states = engine.run(cases)
    assert engine.report.strategies[cases[0].bucket_key()] == "stacked[rkc]"
    assert engine.report.dispatches == 1 and engine.report.padded_cases == 1
    jcases = [jens.EnsembleCase(shape=c.shape, nt=c.nt, eps=c.eps, k=c.k, dt=c.dt, dh=c.dh,
                                test=True) for c in cases]
    want = jens.EnsembleEngine(method=JAX_METHOD[method], stepper="rkc", stages=4).run(jcases)
    for c, got, w in zip(cases, states, want, strict=True):
        assert _rel(got, w) <= 1e-12
        solo = Solver2D(*c.shape, c.nt, c.eps, k=c.k, dt=c.dt, dh=c.dh, method=method,
                        stepper="rkc", stages=4, device=CPU, dtype=F64)
        solo.test_init()
        assert np.array_equal(got, solo.do_work())


def test_expo_bucket_and_1d_fft_bucket_match_jax():
    for shape, stepper, stages in (((24, 24), "expo", 1), ((40,), "rkc", 3)):
        cases = [EnsembleCase(shape=shape, nt=4, eps=3, k=k, dt=dt, dh=1.0 / shape[0])
                 for k, dt in PHYSICS[:2]]
        got = EnsembleEngine(method="fft", stepper=stepper, stages=stages, device=CPU,
                             dtype=F64).run(cases)
        jcases = [jens.EnsembleCase(shape=shape, nt=4, eps=3, k=c.k, dt=c.dt, dh=c.dh)
                  for c in cases]
        want = jens.EnsembleEngine(method="fft", stepper=stepper, stages=stages).run(jcases)
        assert all(_rel(a, b) <= 1e-12 for a, b in zip(got, want, strict=True))


def test_stepper_joins_the_engine_key_and_euler_only_variants_are_refused():
    e1 = EnsembleEngine(method="fft", stepper="rkc", stages=4, device=CPU)
    e1.run(_cases()[:1])
    e2 = EnsembleEngine(method="fft", device=CPU)
    e2.run(_cases()[:1])
    (k1,), (k2,) = e1._programs.keys(), e2._programs.keys()
    assert k1 != k2 and "rkc" in k1 and "euler" in k2
    assert e2.report.strategies[_cases()[0].bucket_key()] == "vmap"
    sib = e1.sibling()
    assert (sib.stepper, sib.stages, sib.method) == ("rkc", 4, "fft")
    assert e1.engine_key() == ("rkc", 4, "fft", "f32")
    assert e1.engine_for("rkc", 4, "fft", "f32") is e1
    picked = EnsembleEngine(method="cuda", comm="fused", variant="carried", ksteps=2,
                            device=CPU).engine_for("rkc", 8, "fft", "f32")
    assert (picked.stepper, picked.stages, picked.method, picked.variant, picked.comm,
            picked.ksteps) == ("rkc", 8, "fft", "auto", "collective", 0)
    for variant in ("carried", "superstep", "vmap"):
        with pytest.raises(ValueError, match="Euler-only"):
            EnsembleEngine(method="cuda", stepper="rkc", stages=4, variant=variant,
                           ksteps=2 if variant == "superstep" else 0, device=CPU)
    with pytest.raises(ValueError, match="method='fft'"):
        EnsembleEngine(method="conv", stepper="expo", device=CPU)
    with pytest.raises(ValueError, match="stages"):
        EnsembleEngine(method="conv", stepper="rkc", device=CPU)
    with pytest.raises(ValueError, match="unknown stepper"):
        EnsembleEngine(stepper="leapfrog", device=CPU)


# -- the solvers' other loops carry the stepper ------------------------------------------

def test_throttled_logged_and_1d_solves_carry_the_stepper():
    kw = dict(k=1.0, dt=0.0045, dh=0.02, method="fft", stepper="rkc", stages=8, device=CPU)
    ref = Solver2D(30, 30, 6, 5, **kw)
    ref.test_init()
    want = ref.do_work()
    seen = []
    for extra in (dict(nd=2), dict(logger=lambda t, u: seen.append(t), nlog=2)):
        s = Solver2D(30, 30, 6, 5, **kw, **extra)
        s.test_init()
        assert np.array_equal(s.do_work(), want)
    assert seen == [0, 2, 4]
    j = JaxSolver2D(30, 30, 6, 5, k=1.0, dt=0.0045, dh=0.02, backend="jit", method="fft",
                    stepper="rkc", stages=8, dtype=jnp.float64)
    j.test_init()
    assert _rel(want, np.asarray(j.do_work())) <= 1e-12
    j1 = JaxSolver1D(40, 9, 4, k=1.0, dt=0.002, dx=0.025, backend="jit", method="fft",
                     stepper="expo", stages=1, dtype=jnp.float64)
    j1.test_init()
    t1 = Solver1D(40, 9, 4, k=1.0, dt=0.002, dx=0.025, method="fft", stepper="expo",
                  stages=1, device=CPU)
    t1.test_init()
    assert _rel(t1.do_work(), np.asarray(j1.do_work())) <= 1e-12


def test_checkpointed_rkc_and_expo_solves_resume_bitwise(tmp_path):
    path = str(tmp_path / "state.npz")
    for kw in (dict(method="cuda", stepper="rkc", stages=4, dt=1e-3),
               dict(method="fft", stepper="expo", stages=1, dt=1e-3)):
        def make(nt, **extra):
            return Solver2D(20, 20, nt, 3, k=1.0, dh=0.05, device=CPU, **kw, **extra)

        full = make(9)
        full.test_init()
        want = full.do_work()
        first = make(9, checkpoint_path=path, ncheckpoint=3)
        first.test_init()
        first.nt = 7  # stopped after 7 steps; its last checkpoint is step 6
        first.do_work()
        second = make(9, checkpoint_path=path, ncheckpoint=3)
        second.test_init()
        second.resume(path)
        assert second.t0 == 6
        assert np.array_equal(second.do_work(), want), kw


def test_convert_resumes_a_jax_rkc_state():
    kw = dict(k=1.0, dt=0.002, dh=0.02, backend="jit", method="conv", stepper="rkc",
              stages=4, dtype=jnp.float64)
    full = JaxSolver2D(30, 30, 10, 4, **kw)
    full.test_init()
    full.do_work()
    first = JaxSolver2D(30, 30, 4, 4, **kw)
    first.test_init()
    first.do_work()
    s = solver2d_from_jax_state(first._ckpt_params(), np.asarray(first.u), 4, device=CPU,
                                dtype=F64, nt=10, stepper="rkc", stages=4, method="cuda")
    assert (s.t0, s.stepper, s.stages) == (4, "rkc", 4)
    s.do_work()
    assert _rel(s.u, np.asarray(full.u)) <= 1e-12
    assert s.error_l2 / 900 <= L2_THRESHOLD


# -- the CLIs ----------------------------------------------------------------------------

def _call(main, argv, stdin=""):
    """(rc, stdout, stderr) of an in-process CLI call, the timing row's
    wall masked."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = old
    wall = re.compile(r"^(\d+,\s+)[0-9.e+-]+(,)", re.M)
    return rc, wall.sub(r"\1T\2", out.getvalue()), err.getvalue()


#: tests/test_cli.py::test_2d_fft_and_stepper_surface, row for row
CLI_SURFACE = [
    ("solve2d", ["--test_batch", "--method", "fft"], "1\n50 50 45 5 1 0.0005 0.02\n"),
    ("solve2d", ["--test_batch", "--stepper", "rkc", "--superstep-stages", "8"],
     "1\n50 50 5 5 1 0.0045 0.02\n"),
    ("solve2d", ["--test", "--stepper", "rkc", "--nt", "2", "--cmp", "0"], ""),
    ("solve2d", ["--test", "--stepper", "rkc", "--superstep-stages", "2", "--dt", "0.1"], ""),
    ("solve2d", ["--test", "--stepper", "expo"], ""),
    ("solve3d", ["--test", "--method", "fft", "--distributed", "--comm", "fused"], ""),
    ("solve2d", ["--test", "--nt", "2", "--cmp", "0"], ""),
    ("solve1d", ["--test_batch", "--method", "fft", "--stepper", "rkc"],
     "1\n50 45 5 1 0.001 0.02\n"),
    ("solve3d", ["--test_batch", "--method", "fft", "--stepper", "rkc",
                 "--superstep-stages", "4"], "1\n16 16 16 20 3 1 0.0005 0.0625\n"),
    ("solve1d", ["--test", "--method", "fft", "--stepper", "expo", "--dt", "0.05",
                 "--superstep-stages", "1", "--cmp", "0"], ""),
]
MAINS = {"solve1d": (solve1d.main, jsolve1d.main), "solve2d": (solve2d.main, jsolve2d.main),
         "solve3d": (solve3d.main, jsolve3d.main)}


@pytest.mark.parametrize("cli,argv,stdin", CLI_SURFACE)
def test_cli_stepper_surface_matches_jax(cli, argv, stdin):
    port, jax_main = MAINS[cli]
    got = _call(port, argv + ["--platform", "cpu"], stdin)
    want = _call(jax_main, argv + ["--platform", "cpu"], stdin)
    assert got == want


@pytest.mark.parametrize("argv,message", [
    (["--stepper", "rkc", "--superstep-stages", "1"], "needs --superstep-stages >= 2"),
    (["--superstep-stages", "3"], "--stepper euler takes no stage count"),
    (["--superstep-stages", "-1", "--stepper", "expo", "--method", "fft"], "must be >= 0"),
    (["--stepper", "rkc", "--backend", "oracle"], "--backend oracle is Euler-only"),
])
@pytest.mark.parametrize("cli", ["solve1d", "solve2d", "solve3d"])
def test_cli_stepper_refusals(cli, argv, message, capsys):
    assert MAINS[cli][0](["--test", "--platform", "cpu"] + argv) == 1
    assert message in capsys.readouterr().err


def test_solve3d_distributed_keeps_its_refusals(capsys):
    for argv, message in (
            (["--method", "fft", "--comm", "fused"],
             "--method fft runs on the collective all-to-all pencil transposes"),
            (["--stepper", "expo"], "--stepper expo integrates in the spectral domain; it "
                                    "requires --method fft"),
            (["--method", "fft", "--superstep", "2"], "--method fft has no superstep form")):
        assert solve3d.main(["--test", "--platform", "cpu", "--distributed"] + argv) == 1
        assert capsys.readouterr().err.startswith(message)


def _actions(parser) -> dict:
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings}


PORT_NAMES = {"pallas": "cuda"}  # the port's name for its kernel method


@pytest.mark.parametrize("cli", ["solve1d", "solve2d", "solve3d"])
def test_cli_parsers_match_jax(cli):
    port = _actions({"solve1d": solve1d, "solve2d": solve2d, "solve3d": solve3d}[cli]
                    .build_parser())
    jax = _actions({"solve1d": jsolve1d, "solve2d": jsolve2d, "solve3d": jsolve3d}[cli]
                   .build_parser())
    for flag in ("--stepper", "--superstep-stages"):
        a, b = port[flag], jax[flag]
        assert (a.dest, a.default, a.type, a.choices) == (b.dest, b.default, b.type, b.choices)
    assert sorted(port["--method"].choices) == sorted(
        PORT_NAMES.get(m, m) for m in jax["--method"].choices)
    assert port["--method"].default == jax["--method"].default
    assert math.isclose(TC.rkc_beta(TSt.DEFAULT_STAGES), JC.rkc_beta(JSt.DEFAULT_STAGES))
