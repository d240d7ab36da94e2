"""The port's engine picker (serve/picker.py) against the JAX package's.

* Over a grid of shapes, eps, horizons, accuracies, deadlines, methods,
  ``allow_fft``/``allow_expo``, the bf16 tier and the analytic and a flat
  measured rate model, the port picks the same ``EngineChoice`` (every field,
  floats to 1e-12 relative) or refuses with the same ``PickerRefusal`` text.
* The model functions (``analytic_rate_fn``, ``modeled_error``,
  ``modeled_expo_defect``, ``_expo_min_stages``) give the JAX values to
  1e-15 relative; ``NLHEAT_PICK_STAGES`` reshapes both ladders alike.
* A mesh pick on a registered cloud gives the JAX choice, and the picker
  never touches ``torch.cuda``.
* A pick served through the port's pipeline is bitwise the offline sibling
  engine's run and meets the accuracy it promised.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.serve import picker as P
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_tpu.serve import picker as J

CPU = "cpu"


def euler_bound(eps: int, k: float, dh: float) -> float:
    from nonlocalheatequation_torch.ops.constants import c_2d, stable_dt
    from nonlocalheatequation_torch.ops.stencil import horizon_mask_2d

    return stable_dt(c_2d(k, eps, dh), dh, 2, float(horizon_mask_2d(eps).sum()))


def flat_rate(ms=1.0, fft_ms=None):
    """Deterministic rate_fn (tests/test_distributed_rkc.py's): every stencil
    apply costs ``ms``, fft ``fft_ms`` (2x by default), bf16 0.7x."""
    fm = fft_ms if fft_ms is not None else 2.0 * ms

    def rate(method, shape, eps, precision):
        return (fm if method == "fft" else ms) * (0.7 if precision == "bf16" else 1.0)

    return rate


def _pick(mod, *args, **kw):
    try:
        return mod.pick_engine(*args, **kw)
    except (mod.PickerRefusal, ValueError) as e:
        return (type(e).__name__, str(e))


def _same(a, b, what):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert a == b, what
        return
    wa, wb = a.wire(), b.wire()
    for f in wa:
        if isinstance(wa[f], float):
            assert math.isclose(wa[f], wb[f], rel_tol=1e-12, abs_tol=0.0), (what, f)
        else:
            assert wa[f] == wb[f], (what, f)


@pytest.mark.parametrize("shape,eps", [((24, 24), 2), ((24, 24), 5), ((32, 32), 3),
                                       ((32, 32), 4)])
@pytest.mark.parametrize("accuracy", [1e-13, 1e-9, 2e-6, 1e-6, 1e-4])
def test_picks_and_refusals_equal_the_jax_picker(shape, eps, accuracy):
    dh = 1.0 / shape[0]
    eul = euler_bound(eps, 1.0, dh)
    picks = 0
    for horizon, deadline, method, fft, expo, rates in itertools.product(
            (3, 30, 300), (None, 1e-9, 0.5, 50.0), ("auto", "fft"), (True, False),
            (None, True, False), ("analytic", "flat", "cheap-fft")):
        T = horizon * eul
        kw = dict(method=method, allow_fft=fft, allow_expo=expo)
        if rates == "flat":
            kw["rate_fn"] = flat_rate()
        elif rates == "cheap-fft":
            kw["rate_fn"] = flat_rate(fft_ms=1e-3)
        what = (horizon, deadline, method, fft, expo, rates)
        a = _pick(J, shape, eps, 1.0, dh, T, accuracy, deadline, **kw)
        b = _pick(P, shape, eps, 1.0, dh, T, accuracy, deadline, **kw)
        _same(a, b, what)
        picks += not isinstance(b, tuple)
    assert picks > 0


@pytest.mark.parametrize("expo_stages", [0, 1, 3])
def test_forced_expo_and_bf16_tiers_equal_the_jax_picker(monkeypatch, expo_stages):
    # the forced expo candidate (NLHEAT_PICK_EXPO=1) at its substep count, and
    # a grid coarse enough that the bf16 tier's accuracy-capped dt competes
    monkeypatch.setenv("NLHEAT_PICK_EXPO", "1")
    for shape, eps, dh, acc in (((32, 32), 2, 0.05, 1e-4), ((24, 24), 3, 0.01, 1e-5)):
        T = 30 * euler_bound(eps, 1.0, dh)
        for rate in (None, flat_rate(fft_ms=1e-6)):
            kw = dict(rate_fn=rate, expo_stages=expo_stages)
            _same(_pick(J, shape, eps, 1.0, dh, T, acc, **kw),
                  _pick(P, shape, eps, 1.0, dh, T, acc, **kw), (shape, expo_stages))
    coarse = P.pick_engine((32, 32), 2, 1.0, 0.05, 30 * euler_bound(2, 1.0, 0.05), 1e-4,
                           rate_fn=flat_rate(), allow_expo=False)
    assert coarse.precision == "bf16"


@pytest.mark.parametrize("ladder", ["16", "4,8", "2,32", "1,4", "x"])
def test_stage_ladder_env_equals_the_jax_picker(monkeypatch, ladder):
    monkeypatch.setenv("NLHEAT_PICK_STAGES", ladder)
    T = 30 * euler_bound(2, 1.0, 0.01)
    a = _pick(J, (32, 32), 2, 1.0, 0.01, T, 1e-6, rate_fn=flat_rate())
    b = _pick(P, (32, 32), 2, 1.0, 0.01, T, 1e-6, rate_fn=flat_rate())
    _same(a, b, ladder)
    if ladder == "16":
        assert (b.stepper, b.stages) == ("rkc", 16)
    if ladder in ("1,4", "x"):
        assert b[0] == "ValueError" and "NLHEAT_PICK_STAGES" in b[1]


@pytest.mark.parametrize("shape", [(24, 24), (32, 32), (50,), (9, 10, 11)])
def test_model_functions_equal_the_jax_models(shape):
    rel = dict(rel_tol=1e-15, abs_tol=0.0)
    for eps, prec, method in itertools.product((2, 5), ("f32", "bf16"), ("auto", "fft",
                                                                          "gather")):
        assert math.isclose(P.analytic_rate_fn(method, shape, eps, prec),
                            J.analytic_rate_fn(method, shape, eps, prec), **rel)
    for T, dt in itertools.product((1e-3, 0.05, 1.0), (1e-7, 1e-5, 1e-3)):
        assert math.isclose(P.modeled_error(len(shape), T, dt),
                            J.modeled_error(len(shape), T, dt), **rel)
    for eps, T, S, acc in itertools.product((2, 5), (1e-4, 1e-2), (1, 2, 8),
                                            (1e-12, 1e-6, 1e-2)):
        eul = 1e-5 * eps
        assert math.isclose(P.modeled_expo_defect(shape, eps, eul, T, S),
                            J.modeled_expo_defect(shape, eps, eul, T, S), **rel)
        assert P._expo_min_stages(shape, eps, eul, T, acc) == \
            J._expo_min_stages(shape, eps, eul, T, acc)


def test_engine_choice_surface_equals_the_jax_class():
    ch = P.pick_engine((32, 32), 2, 1.0, 0.01, 30 * euler_bound(2, 1.0, 0.01), 1e-6,
                       rate_fn=flat_rate())
    jch = J.EngineChoice.from_wire(ch.wire())
    assert P.EngineChoice.from_wire(jch.wire()) == ch
    assert (ch.key(), ch.engine_kwargs()) == (jch.key(), jch.engine_kwargs())
    assert ch.rates == "measured" and P.EngineChoice.from_wire(None) is None
    assert P._stage_ladder() == J._stage_ladder() == P.STAGE_LADDER
    for name in ("ERR_SAFETY", "NS_PER_STENCIL_POINT", "NS_PER_FFT_POINT", "BF16_RATE",
                 "EXPO_CORR_APPLIES", "EXPO_DEFECT_COEF", "EXPO_DEFECT_CAP"):
        assert getattr(P, name) == getattr(J, name), name
    with pytest.raises(P.PickerRefusal, match="deadline") as refused:
        P.pick_engine((32, 32), 2, 1.0, 0.01, 1e-3, 1e-6, deadline_ms=1e-9)
    assert refused.value.best is not None
    for bad in (dict(T_final=0.0), dict(accuracy=0.0), dict(deadline_ms=-1.0)):
        kw = dict(T_final=1e-3, accuracy=1e-6, deadline_ms=None)
        kw.update(bad)
        with pytest.raises(ValueError):
            P.pick_engine((32, 32), 2, 1.0, 0.01, **kw)


def _grid_cloud(n, dh):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.stack([ii.ravel() * dh, jj.ravel() * dh], axis=1)


def test_mesh_axis_pick_equals_the_jax_pick_and_touches_no_card(tmp_path, monkeypatch):
    # tests/test_pallas_gather.py:223's case, registered in both packages
    from nonlocalheatequation_torch.serve.meshes import MeshStore, get_mesh_op
    from nonlocalheatequation_tpu.serve.meshes import MeshStore as JMeshStore

    n, dh = 20, 1.0 / 20
    pts = _grid_cloud(n, dh)
    ours = MeshStore(str(tmp_path / "torch"))
    theirs = JMeshStore(str(tmp_path / "jax"))
    mhash = ours.put(pts, 3 * dh, dh * dh)
    assert theirs.put(pts, 3 * dh, dh * dh) == mhash

    def no_card(*a, **k):
        raise AssertionError("the picker touched torch.cuda")

    for name in ("is_available", "get_device_name", "device_count", "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    for T, acc, dl, rate in ((5e-4, 1e-5, None, None), (5e-3, 1e-6, None, flat_rate()),
                             (5e-4, 1e-4, 1e-9, flat_rate()), (5e-4, 1e-13, None, None)):
        a = _pick(J, (1,), 0, 1.0, 1.0, T, acc, dl, mesh=mhash, mesh_dir=theirs.root,
                  rate_fn=rate)
        b = _pick(P, (1,), 0, 1.0, 1.0, T, acc, dl, mesh=mhash, mesh_dir=ours.root,
                  rate_fn=rate)
        _same(a, b, (T, acc, dl))
    ch = P.pick_engine((1,), 0, 1.0, 1.0, T_final=5e-4, accuracy=1e-5, mesh=mhash,
                       mesh_dir=ours.root)
    assert (ch.method, ch.stepper) == ("gather", "euler")
    monkeypatch.undo()
    op = get_mesh_op(mhash, 1.0, 1.0, mesh_dir=ours.root, device=CPU)
    assert ch.dt <= 0.8 / float(np.max(op.c * op.wsum)) + 1e-15


def test_served_pick_is_bitwise_its_offline_sibling_and_meets_its_accuracy():
    # tests/test_distributed_rkc.py:396's case on the port's pipeline
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    eps, k, dh = 2, 1.0, 0.01
    ch = P.pick_engine((24, 24), eps, k, dh, 30 * euler_bound(eps, k, dh), 1e-6,
                       rate_fn=flat_rate(fft_ms=1e9), method="cuda")
    assert (ch.stepper, ch.method) == ("rkc", "cuda")
    cases = [EnsembleCase(shape=(24, 24), nt=ch.steps, eps=eps, k=k, dt=ch.dt, dh=dh,
                          test=True) for _ in range(3)]
    with ServePipeline(method="cuda", device=CPU, depth=2, window_ms=0.0) as pipe:
        h0 = pipe.submit(EnsembleCase(shape=(24, 24), nt=3, eps=eps, k=k, dt=1e-5, dh=dh,
                                      test=True))
        hs = [pipe.submit(c, engine=ch) for c in cases]
        pipe.drain()
        assert h0.result is not None and pipe.report.buckets == 2
    offline = EnsembleEngine(device=CPU, **ch.engine_kwargs()).run(cases)
    assert all(np.array_equal(h.result, w) for h, w in zip(hs, offline, strict=True))
    want = np.cos(2.0 * np.pi * ch.steps * ch.dt) * NonlocalOp2D(eps, k, ch.dt, dh) \
        .spatial_profile(24, 24)
    assert float(((hs[0].result - want) ** 2).sum()) / 24 ** 2 <= 1e-6
