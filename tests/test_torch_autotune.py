"""The port's multi-step dispatch and its 2D autotuner, on the CPU.

``make_multi_step_fn`` tunes CUDA tensors only (tests/test_torch_card.py
holds that on the card); a CPU tensor runs the per-step loop.  The tuner
itself is called here with ``device="cpu"``, where it times the plain
versions.  Every variant computes the same function bit for bit, so
equality alone cannot show which one ran: spies on the makers and on the
probes pin it, as tests/test_pallas.py:229-267 does for the JAX package.
tests/conftest.py sets NLHEAT_AUTOTUNE_CACHE="" (no file), so each test
that wants a file names one under tmp_path.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp2D,
    make_multi_step_fn,
    make_multi_step_fn_base,
)
from nonlocalheatequation_torch.utils import autotune
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D

torch.set_num_threads(1)

ALL = {"per-step", "carried", "superstep2", "superstep3", "resident"}


@pytest.fixture(autouse=True)
def fresh_tuner(monkeypatch):
    monkeypatch.setattr(autotune, "_memory_cache", {})


@pytest.fixture
def spies(monkeypatch):
    calls = []
    for name in ("make_carried_multi_step_fn", "make_superstep_multi_step_fn",
                 "make_resident_multi_step_fn"):
        real = getattr(ck, name)
        monkeypatch.setattr(ck, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n.split("_")[1]) or _r(*a, **kw))
    return calls


@pytest.fixture
def probes(monkeypatch):
    """The initial state of every probe, in order."""
    seen = []
    real = autotune._measure
    monkeypatch.setattr(autotune, "_measure", lambda maker, op, u:
                        seen.append(u) or real(maker, op, u))
    return seen


def _op(n=40, eps=5, precision="f32", resync_every=0, method="cuda"):
    return NonlocalOp2D(eps, 1.0, 1e-6, 1.0 / n, method=method, precision=precision,
                        resync_every=resync_every)


def _u(n=40, dtype=torch.float64, seed=2):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, n)), dtype=dtype)


def _pick(op, nsteps, shape=(40, 40), dtype=torch.float64):
    return autotune.pick_multi_step_fn(op, nsteps, shape, dtype, "cpu")


@pytest.mark.parametrize("case", ["cuda", "bf16", "bf16-resync", "test-form", "conv", "auto"])
def test_cpu_tensors_run_the_per_step_loop(monkeypatch, spies, probes, case):
    # the JAX package's manual knobs are not read by the port
    for knob, value in (("NLHEAT_AUTOTUNE", "1"), ("NLHEAT_SUPERSTEP", "2"),
                        ("NLHEAT_RESIDENT", "1")):
        monkeypatch.setenv(knob, value)
    op = {"cuda": _op(), "bf16": _op(precision="bf16"),
          "bf16-resync": _op(precision="bf16", resync_every=2), "test-form": _op(),
          "conv": _op(method="conv"), "auto": _op(method="auto")}[case]
    g = np.ones((40, 40)) if case == "test-form" else None
    u = _u(dtype=torch.float32 if case.startswith("bf16") else torch.float64)
    got = make_multi_step_fn(op, 5, g, g)(u, 0)
    assert torch.equal(got, make_multi_step_fn_base(op, 5, g, g)(u, 0))
    assert spies == [] and probes == [] and autotune.records() == {}


def test_autotune_on_the_cpu_picks_a_winner_once(spies, probes):
    op, u = _op(), _u()
    ref = make_multi_step_fn_base(op, 6)(u, 0)
    fn, winner = _pick(op, 6)
    assert torch.equal(fn(u, 0), ref)
    (key, entry), = autotune.records().items()
    assert key == f"k{autotune.kernels_digest()}/cpu/cuda/40x40/eps5/float64"
    assert set(entry["ms_per_step"]) == ALL
    assert entry["winner"] == winner
    assert len(probes) == 5
    # a second pick for the same shape probes nothing and runs the same winner
    fn2, winner2 = _pick(op, 6)
    assert winner2 == winner and len(probes) == 5
    assert torch.equal(fn2(_u(seed=9), 0), make_multi_step_fn_base(op, 6)(_u(seed=9), 0))


def test_autotune_repicks_when_the_winner_does_not_fit_nsteps(spies, probes):
    op, u = _op(), _u()
    _pick(op, 6)
    key, = autotune.records()
    rates = {"per-step": 5.0, "carried": 3.0, "superstep2": 2.0, "superstep3": 1.0,
             "resident": 4.0}
    autotune._memory_cache[key] = {"winner": "superstep3", "ms_per_step": rates}
    assert _pick(op, 6)[1] == "superstep3"
    # 2 steps: superstep3 does not fit; the fastest that does is superstep2
    fn, winner = _pick(op, 2)
    assert winner == "superstep2" and len(probes) == 5
    assert torch.equal(fn(u, 0), make_multi_step_fn_base(op, 2)(u, 0))
    # 1 step: no superstep fits; carried is the fastest left
    assert _pick(op, 1)[1] == "carried"
    # an entry that lacks a candidate fitting this call is completed, not trusted
    autotune._memory_cache[key] = {"winner": "per-step", "ms_per_step": {"per-step": 1.0}}
    _pick(op, 6)
    assert len(probes) == 9
    assert autotune._memory_cache[key]["ms_per_step"]["per-step"] == 1.0


def test_autotune_file_cache(monkeypatch, tmp_path, probes):
    path = tmp_path / "nested" / "tune.json"
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(path))
    op = _op(precision="bf16")
    _fn, winner = _pick(op, 4, (24, 40), torch.float32)
    saved = json.loads(path.read_text())
    (key, entry), = saved.items()
    assert key == f"k{autotune.kernels_digest()}/cpu/cuda/24x40/eps5/float32/prec-bf16"
    assert entry["winner"] == winner
    assert set(entry["ms_per_step"]) == ALL - {"resident"}
    # another process (a fresh memory cache) reads the file and probes nothing
    monkeypatch.setattr(autotune, "_memory_cache", {})
    assert _pick(op, 4, (24, 40), torch.float32)[1] == winner
    assert len(probes) == 4


@pytest.mark.parametrize("changed", ["superstep2d.cu", "stencil_tile.cuh"])
def test_a_kernel_change_misses_the_cache(monkeypatch, tmp_path, probes, changed):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    op = _op()
    _pick(op, 6)
    before = autotune.kernels_digest()
    assert len(probes) == 5
    # a later process of a checkout whose kernel changed: the record does not
    # apply, so every candidate is probed again
    with open(csrc / changed, "a") as f:
        f.write("\n// changed\n")
    monkeypatch.setattr(autotune, "_memory_cache", {})
    _pick(op, 6)
    assert autotune.kernels_digest() != before and len(probes) == 10
    assert len(json.loads((tmp_path / "tune.json").read_text())) == 2


def test_probe_state_is_made_once_per_pick(monkeypatch, probes):
    made = []
    real = autotune._probe_state
    monkeypatch.setattr(autotune, "_probe_state", lambda *a: made.append(a) or real(*a))
    _pick(_op(), 6, (24, 40), torch.float32)
    assert made == [((24, 40), torch.float32, torch.device("cpu"))]
    assert len(probes) == 5 and all(u is probes[0] for u in probes)
    # seeded: the same state every time, of the probed shape and dtype
    state = real((24, 40), torch.float32, torch.device("cpu"))
    assert torch.equal(probes[0], state) and state.dtype == torch.float32


def test_default_cache_file_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("NLHEAT_AUTOTUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune._cache_path() == os.path.join(str(tmp_path), "nlheat", "autotune_torch.json")
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", "")
    assert autotune._cache_path() is None


def test_a_failing_candidate_raises(monkeypatch):
    def broken(*_a, **_kw):
        raise RuntimeError("carried2d launch failed: cudaGetLastError 700")

    monkeypatch.setattr(ck, "make_carried_multi_step_fn", broken)
    with pytest.raises(RuntimeError, match="carried2d launch failed"):
        _pick(_op(), 4)
    assert autotune.records() == {}


def test_unported_tuner_dimensions_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="no 1D branch"):
        autotune.candidates(_op(), (8,), 4, torch.float64, "cpu")
    # the precision dimension is ported: the bf16 twins compete behind the gate
    monkeypatch.setenv("NLHEAT_TUNE_PRECISION", "1")
    _fn, winner = autotune.pick_multi_step_fn(_op(), 4, (8, 8), torch.float64, "cpu")
    (entry,) = autotune.records().values()
    assert {"per-step+bf16", "carried+bf16"} <= set(entry["ms_per_step"])
    assert entry["bf16_gate"]["ok"] or not winner.endswith("+bf16")


def test_candidates_follow_the_gates(monkeypatch):
    op = _op()
    names = lambda n, o=op: [c for c, _m in autotune.candidates(  # noqa: E731
        o, (40, 40), n, torch.float64, "cpu")]
    assert names(6) == ["per-step", "carried", "superstep2", "superstep3", "resident"]
    assert names(2) == ["per-step", "carried", "superstep2", "resident"]
    assert names(1) == ["per-step", "carried", "resident"]
    assert names(6, _op(precision="bf16")) == ["per-step", "carried", "superstep2",
                                               "superstep3"]
    monkeypatch.setattr(ck, "fits_resident", lambda *a, **k: False)
    monkeypatch.setattr(ck, "fits_superstep", lambda nx, ny, eps, k, *a, **kw: k == 2)
    assert names(6) == ["per-step", "carried", "superstep2"]


@pytest.mark.parametrize("n,nt,eps", [(40, 12, 4), (33, 7, 3)])
def test_solver2d_production_solve_tuned_matches_jax(probes, n, nt, eps):
    u0 = np.random.default_rng(n + nt).normal(size=(n, n))
    dh = 1.0 / n
    probe = NonlocalOp2D(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)
    ours = Solver2D(n, n, nt, eps, k=1.0, dt=dt, dh=dh, method="cuda", device="cpu",
                    dtype=torch.float64)
    ours.input_init(u0)
    got = ours.do_work()
    assert probes == []  # a CPU solve runs the per-step loop
    ref = JaxSolver2D(n, n, nt, eps, k=1.0, dt=dt, dh=dh, backend="jit", method="pallas")
    ref.input_init(u0)
    want = np.asarray(ref.do_work())
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 1e-12
    # the tuner's winner, and every candidate it could pick, gives the same bits
    u = torch.as_tensor(u0)
    fn, _winner = autotune.pick_multi_step_fn(ours.op, nt, (n, n), torch.float64, "cpu")
    assert len(probes) == 5 and np.array_equal(fn(u, 0).numpy(), got)
    for name, maker in autotune.candidates(ours.op, (n, n), nt, torch.float64, "cpu"):
        assert np.array_equal(maker(ours.op, nt, torch.float64)(u, 0).numpy(), got), name
